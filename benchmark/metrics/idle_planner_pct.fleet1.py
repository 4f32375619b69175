"""Share of the traced window in which the device was idle while the host was
in the planner's own time (lpv_solve / nl_solve, SQP iterations, QP
builds), % (the program's spans)."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "planner")
