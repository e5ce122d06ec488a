"""Seconds from the process's start to the first timed epoch: CUDA start,
the kernels' build or load, data generation, the graph and layout build,
model and optimizer, and the first block (warm-up epoch, capture) with
the checked steps."""


def read(ctx):
    return ctx["setup_s"]
