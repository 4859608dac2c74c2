"""Seconds from the process's start (its start time in /proc) to the
window's opening: imports, inputs, weights, the loop's set-up and
warm-up, and on a checkout's first run the port's nvcc build."""


def read(r):
    return r.setup_s
