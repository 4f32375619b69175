"""Share of the traced window in which the device was idle while the host was
in the ADMM loop's own time (admm_solve, its epochs and syncs), % (the
program's spans, split by benchmark/racing.py)."""
from benchmark import racing


def read(run):
    return racing.idle_pct(run, "admm")
