"""The per-bucket column attention's share of its roofline (K6 / K7 at bs
100, f32 on the parity configuration): the least time of the captured
steps' bucket-attention forwards and backwards, one of each a layer and an
event (bytes / 3.35 TB/s or operations / the peak of the configuration's
stated precision, from the attention's shapes), over the device time of
the kernels the name map calls K6 and K7. None where no K6 / K7 kernel
ran."""


def read(t):
    c = t.capture
    if not c or not c["steps"]:
        return None
    measured = t.kernel_s(("K6", "K7"))
    if measured <= 0:
        return None
    bound = t.flops.attention_bound_s(t.cfg, t.n, backward=True) * t.cfg["batch_size"]
    return 100.0 * bound * c["steps"] / measured
