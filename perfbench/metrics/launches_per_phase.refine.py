"""Kernel launches per sweep phase, counted in the device trace over the
traced calls."""

LAYER = "batched window LM (solver/multi_window.py, solver/lm.py)"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "refine_sweep_s"


def read(r):
    trace, phases = r.get("trace"), r.get("phases")
    if trace is None or not phases or not trace.launches():
        return None
    return trace.launches() / phases
