from srba_tpu_torch.graph.spantree import KeyframeGraph  # noqa: F401
