from srba_tpu_torch.ops.lie import SE2  # noqa: F401
