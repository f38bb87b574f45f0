"""Share of its HBM roofline that the SPD block-inverse kernel reaches:
the bytes it must move, each block read once and written once (d*d*4*2
bytes per block, from the port's ``spd_inverse_cuda.launches_by_shape``
over the traced calls), over 3.35 TB/s, against the kernel's device time in
the trace."""

from metrics_common import spd_roofline

LAYER = "SPD block-inverse kernel (csrc/spd_inverse.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "refine_sweep_s"


def read(r):
    return spd_roofline(r)
