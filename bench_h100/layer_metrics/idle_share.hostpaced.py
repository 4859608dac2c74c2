"""Share of the traced run's window in which no op ran on the device, in a
cell whose pace the host's dispatch sets: 1 - (device busy seconds a step,
from a CUDA-only profiler capture of the steps after the window) / (the
unprofiled window's seconds a step). It falls as the dispatch gets faster,
until the card sets the pace."""


def read(t):
    c = t.capture
    if not c or not c["steps"] or not t.steps:
        return None
    return 100.0 * (1.0 - t.busy_per_step_s / (t.window_s / t.steps))
