"""What the port's profiler recorded while a run's trace was on: the host
stats of its scopes and its counters over the traced calls alone
(``srba_tpu_torch.utils.profiler.TRACED``, summed over the process's
traces; a run makes one)."""

import sys


def traced_profiler(r):
    """The port's ``TRACED`` profiler for the readings ``r`` of a traced
    run, or None: an untraced run, a port that has none, or one not
    loaded."""
    if r.get("trace") is None:
        return None
    mod = sys.modules.get("srba_tpu_torch.utils.profiler")
    return getattr(mod, "TRACED", None)


def counter_pct(r, part: str, whole: str):
    """100 * counter ``part`` / counter ``whole`` over the traced calls, or
    None where either was never counted."""
    prof = traced_profiler(r)
    if prof is None or not prof.counters.get(whole) \
            or part not in prof.counters:
        return None
    return 100.0 * prof.counters[part] / prof.counters[whole]
