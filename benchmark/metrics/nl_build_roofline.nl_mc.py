"""The NL SQP stage-QP builds' share of their roofline, %."""
from benchmark import readers


def read(run):
    return readers.nl_build_roofline(run)
