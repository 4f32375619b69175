"""Share of the traced window in which the device was idle while the host was
in the rollout's own time (the step, exchange, hold ladder, safety filter,
plant), % (the program's spans)."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "rollout")
