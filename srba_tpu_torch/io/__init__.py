from srba_tpu_torch.io.export import (  # noqa: F401
    build_opengl_representation,
    edge_observation_support,
    get_global_graphslam_problem,
    save_graph_as_dot,
    save_graphslam_g2o,
    save_scene_json,
    save_scene_ply,
)
