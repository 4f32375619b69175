"""The ADMM epochs' share of their roofline (epoch-data and epoch kernels), %."""
from benchmark import readers


def read(run):
    return readers.admm_epoch_roofline(run)
