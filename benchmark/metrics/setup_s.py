"""Seconds from the process's start to the first timed request: imports,
the kernels' build where it is not cached, the weights, the program's load,
its warm-up at the cell's shapes and the gRPC connections."""


def read(run):
    return run.setup_s
