from srba_tpu_torch.solver.lm import (  # noqa: F401
    SolverConfig,
    WindowBatch,
    get_solver,
    make_lm_solver,
)
from srba_tpu_torch.solver.window import build_window, write_back  # noqa: F401
