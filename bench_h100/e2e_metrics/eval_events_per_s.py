"""Events evaluated in the window (forward, loss and retrieval metrics, one
host read a pass over the split) over the window's seconds."""


def read(r):
    return r.events / r.window_s if r.steps else None
