"""Share of the observation rows the batched solve runs over that are
real: the port's counters ``refine_obs_rows`` (each window's observations)
over ``refine_obs_slots`` (windows x the phase's padded row count N, the
rows of the one-hot products) over the traced calls."""

from port_traced import counter_pct

LAYER = ("sweep window build (engine/engine.py _sweep_windows, "
         "solver/master.py pack_window_ints)")
UNIT = "%"
SOURCE = "program_counter"
MOVES = "refine_sweep_s"


def read(r):
    return counter_pct(r, "refine_obs_rows", "refine_obs_slots")
