"""Share of the traced window in which the device was idle while the host was
in the racing step's own time (re-projection, both guesses, the failure
bookkeeping, the RK4 plant), % (the program's spans, split by
benchmark/racing.py)."""
from benchmark import racing


def read(run):
    return racing.idle_pct(run, "rollout")
