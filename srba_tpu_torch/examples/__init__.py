"""The tutorials, one for each of the JAX package's ``examples/`` files,
ported to srba_tpu_torch.  Each has ``main(device="cuda")`` and runs as
``python -m srba_tpu_torch.examples.<name> [--device cpu]``."""
