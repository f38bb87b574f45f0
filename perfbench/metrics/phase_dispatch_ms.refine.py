"""Host time to enqueue one sweep phase's batched LM solve: the port's
profiler scope ``refine_map_phase``, mean per phase.  An enqueue time, not
a device time."""

LAYER = "batched window LM (solver/multi_window.py, solver/lm.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "refine_sweep_s"


def read(r):
    phases = r.get("phases")
    if not phases:
        return None
    return 1e3 * r["phase_dispatch_s"] / phases
