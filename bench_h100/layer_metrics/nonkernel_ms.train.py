"""Device ms a step of every device op that the frozen name map does not
attribute to the port's kernels K1-K10 (the model's PyTorch ops: copies,
norms, GEMMs, sorts, Adam), over the captured steps."""


def read(t):
    c = t.capture
    if not c or not c["steps"]:
        return None
    other = sum(s for name, s in c["ops"].items() if t.port_kernel(name) is None)
    return other / c["steps"] * 1e3
