from srba_tpu_torch.parallel.sharding import (  # noqa: F401
    OBS_AXIS,
    make_mesh,
    make_spmd_solver,
    shard_batch,
)
