"""Process start to the first timed call: imports, the kernel library's
load, weights on the device, the warm-up call."""


def read(run):
    return run.setup_s
