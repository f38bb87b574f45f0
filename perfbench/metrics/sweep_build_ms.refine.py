"""Host time to build one sweep phase's windows and pack them: the port's
profiler scopes ``refine_map_windows`` (root plan, ``_sweep_windows``) and
``refine_map_pack`` (bucket shape, padding, ``pack_window_ints``) over the
traced calls, per phase (``refine_map_phase``'s count)."""

from port_traced import traced_profiler

LAYER = ("sweep window build (engine/engine.py _sweep_windows, "
         "solver/master.py pack_window_ints)")
UNIT = "ms"
SOURCE = "program_span"
MOVES = "refine_sweep_s"


def read(r):
    prof = traced_profiler(r)
    if prof is None:
        return None
    phase = prof.stats.get("refine_map_phase")
    build = [prof.stats.get(k) for k in ("refine_map_windows",
                                         "refine_map_pack")]
    if phase is None or not phase.count or None in build:
        return None
    return 1e3 * sum(s.total for s in build) / phase.count
