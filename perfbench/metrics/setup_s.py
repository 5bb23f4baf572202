"""setup_s: process start to the first timed search: imports, the card,
the kernels' libraries (built by nvcc on a checkout's first run) and a
warm-up search at the cell's own shapes."""


def read(run):
    return run.setup_s
