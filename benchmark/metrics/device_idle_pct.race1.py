"""Share of the traced window in which nothing ran on the device, %."""
from benchmark import readers


def read(run):
    return readers.device_idle_pct(run)
