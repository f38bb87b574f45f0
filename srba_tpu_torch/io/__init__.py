from srba_tpu_torch.io.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from srba_tpu_torch.io.config_ini import (  # noqa: F401
    load_noise_ini,
    load_sensor_ini,
)
from srba_tpu_torch.io.dataset_io import (  # noqa: F401
    load_dataset,
    load_ground_truth,
    save_dataset,
    save_ground_truth,
)
from srba_tpu_torch.io.export import (  # noqa: F401
    build_opengl_representation,
    edge_observation_support,
    get_global_graphslam_problem,
    save_graph_as_dot,
    save_graphslam_g2o,
    save_scene_json,
    save_scene_ply,
)
from srba_tpu_torch.io.g2o import load_g2o  # noqa: F401
from srba_tpu_torch.io.html_viewer import save_scene_html  # noqa: F401
from srba_tpu_torch.io.render import (  # noqa: F401
    render_engine_png,
    render_scene_png,
)
