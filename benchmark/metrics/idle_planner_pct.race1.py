"""Share of the traced window in which the device was idle while the host was
in the racing planner's own time (mpcc_solve, its SQP iterations and QP
builds), % (the program's spans, split by benchmark/racing.py)."""
from benchmark import racing


def read(run):
    return racing.idle_pct(run, "planner")
