"""Share of the edge slots the batched solve runs over that are real: the
port's counters ``refine_edge_rows`` (each window's edges) over
``refine_edge_slots`` (windows x the phase's padded edge count E, whose
pose blocks P = 6E size the normal equations) over the traced calls."""

from port_traced import counter_pct

LAYER = ("sweep window build (engine/engine.py _sweep_windows, "
         "solver/master.py pack_window_ints)")
UNIT = "%"
SOURCE = "program_counter"
MOVES = "refine_sweep_s"


def read(r):
    return counter_pct(r, "refine_edge_rows", "refine_edge_slots")
