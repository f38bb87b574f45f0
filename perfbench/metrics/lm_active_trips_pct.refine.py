"""Share of the batched LM's window-trips in which the window had not yet
stopped: the port's counters ``refine_window_trips`` (each window's
``iters``) over ``refine_window_trip_slots`` (windows x the trip cap, the
trips the batch runs) over the traced calls."""

from port_traced import counter_pct

LAYER = "batched window LM (solver/multi_window.py, solver/lm.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "refine_sweep_s"


def read(r):
    return counter_pct(r, "refine_window_trips", "refine_window_trip_slots")
