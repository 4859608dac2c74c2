"""The 95th percentile over every step of the window of the interval between
CUDA events recorded on the stream at consecutive step boundaries: a
stall or a host gap counts in the step it delays."""

import numpy as np


def read(r):
    return float(np.percentile(r.step_ms, 95)) if r.step_ms else None
