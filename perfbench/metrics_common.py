"""Arithmetic that several per-layer metric readers share."""


def spd_roofline(r):
    """The SPD block-inverse kernel's share of its HBM roofline, in %, or
    None where the trace or the launch counts hold nothing."""
    trace, launches = r.get("trace"), r.get("launches_by_shape")
    if trace is None or not launches:
        return None
    t = trace.kernel_time("spd_inverse")
    if t <= 0.0:
        return None
    nbytes = sum(n * b * d * d * 4 * 2 for (b, d), n in launches.items())
    return 100.0 * nbytes / r["hbm_bytes_per_s"] / t
