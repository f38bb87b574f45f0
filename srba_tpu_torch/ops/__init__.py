from srba_tpu_torch.ops.lie import SE2, SE3  # noqa: F401
