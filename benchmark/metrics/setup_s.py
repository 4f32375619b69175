"""Set-up: imports, the CUDA context, the kernel library (built on a checkout's first run), the track and fleet and the cell's warm steps, s."""
from benchmark import readers


def read(run):
    return run.setup_s
