"""Device ms a event of the model's forward in eval mode: CUDA events at the
model's forward pre-hook and forward hook, over every evaluated event of
the traced window."""


def read(t):
    v = t.spans.get("forward_ms")
    return sum(v) / len(v) if v else None
