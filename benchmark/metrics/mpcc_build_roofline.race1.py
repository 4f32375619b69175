"""The MPCC stage-QP builds' share of their roofline (the build kernel), %."""
from benchmark import racing


def read(run):
    return racing.mpcc_build_roofline(run)
