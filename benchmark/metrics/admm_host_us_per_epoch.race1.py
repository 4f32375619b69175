"""The host's time in one ADMM epoch outside its sync, mean over the traced
window, us (the program's spans)."""
from benchmark import spans


def read(run):
    return spans.admm_host_us_per_epoch(run)
