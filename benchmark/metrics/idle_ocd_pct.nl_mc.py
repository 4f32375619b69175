"""Share of the traced window in which the device was idle while the host was
in the OCD loop's own time (its iterations and host checks), % (the
program's spans)."""
from benchmark import spans


def read(run):
    return spans.idle_pct(run, "ocd")
