"""Training events completed in the window (the configuration's batch_size a
step) over the window's seconds; the window ends in a synchronisation."""


def read(r):
    return r.events / r.window_s if r.steps else None
