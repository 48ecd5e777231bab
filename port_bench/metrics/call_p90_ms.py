"""The 90th percentile (linear interpolation) of the wall time of every call
of the window, in ms."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window["call_s"]) * 1e3, 90))
