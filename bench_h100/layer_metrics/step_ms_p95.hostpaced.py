"""The 95th percentile of the step time over every step of the traced run's
(unprofiled) window, from CUDA events at the step boundaries: the tail of a
step whose pace the host's dispatch sets, and whose spread from run to run
is too wide for an end-to-end bound."""

import numpy as np


def read(t):
    return float(np.percentile(t.step_ms, 95)) if t.step_ms else None
