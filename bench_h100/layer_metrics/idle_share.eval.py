"""Share of the traced run's window in which no op ran on the device: 1 -
(device busy seconds a pass, from a CUDA-only profiler capture of the passes
after the window) / (the unprofiled window's seconds a pass). The capture's
own wall time is not used: CUPTI slows the host's launches while it runs."""


def read(t):
    c = t.capture
    if not c or not c["steps"] or not t.steps:
        return None
    return 100.0 * (1.0 - t.busy_per_step_s / (t.window_s / t.steps))
