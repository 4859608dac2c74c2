"""The whole training step's share of the card's peak: the least time of
the step's model arithmetic for each event of the batch (bucket attention
forward and backward at the peak of its stated precision, every linear
layer, hash and the pair loss forward and backward at the f32 peak) over
the measured time a step, the traced run's whole window over all its
steps."""


def read(t):
    if not t.steps:
        return None
    least = t.flops.model_flops_s(t.cfg, t.n, t.pairs, backward=True) * t.cfg["batch_size"]
    return 100.0 * least / (t.window_s / t.steps)
