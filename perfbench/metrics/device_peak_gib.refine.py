"""Peak device memory of the run: ``torch.cuda.max_memory_allocated()``
when the window closes."""

LAYER = "device memory"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "refine_sweep_s"


def read(r):
    peak = r.get("memory_peak_bytes")
    return peak / 2**30 if peak else None
