"""Share of the traced window in which the device was idle while the host was
in the ADMM loop's own time (admm_solve, its epochs and syncs), % (the
program's spans)."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "admm")
