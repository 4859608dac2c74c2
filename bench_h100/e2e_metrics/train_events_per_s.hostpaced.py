"""Training events completed in the window (the configuration's batch_size a
step) over the window's seconds, the window ending in a synchronisation, in
a cell whose pace the host's dispatch sets: its spread from process to
process is the host's, so it has a bound of its own."""


def read(r):
    return r.events / r.window_s if r.steps else None
