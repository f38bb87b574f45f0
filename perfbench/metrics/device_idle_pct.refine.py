"""Share of the traced window in which no operation ran on the device: one
minus the union of the device's activity intervals over the window."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "refine_sweep_s"


def read(r):
    trace = r.get("trace")
    if trace is None or not trace.busy_s or not r.get("window_s"):
        return None
    return 100.0 * (1.0 - trace.busy_s / r["window_s"])
