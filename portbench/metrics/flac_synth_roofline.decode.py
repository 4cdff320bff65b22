"""flac_synth's share of its roofline in the FLAC decode, %: the least
time its bytes need at the card's peak bandwidth (each input byte read
once and each output byte written once, counted from each launch's
tensors by ``launch_bytes`` below) over its device time in the
traced window (the kernels named ``flac_synth_kernel``)."""

# the port's binding whose launches' bytes are counted
KERNEL = ("audiotools_tpu_torch.kernels", "flac_synth")
# the kernels in the trace that it launches
NAMES = ('flac_synth_kernel',)


def read(ctx):
    if ctx["driver"] != "decode" or ctx["trace"] is None:
        return None
    seconds = sum(v["seconds"] for (name, v) in ctx["trace"]["kernels"].items()
                  if any(n in name for n in NAMES))
    moved = (ctx["kernel_bytes"] or {}).get("flac_synth", 0)
    if not seconds or not moved:
        return None
    return moved / ctx["peak_bytes_per_s"] / seconds * 100.0


def launch_bytes(args, _seen):
    """flac_synth(residuals, warmup, qlp, shift, order, taps, out): the
    residual rows, warm-up samples, the ``taps`` coefficient columns in
    use, shifts and orders read once, and the samples written once"""
    (residuals, warmup, qlp, shift, order, taps, out) = args
    rows = qlp.shape[0]
    n = sum(t.numel() * t.element_size()
            for t in (residuals, warmup, shift, order, out))
    return n + rows * min(int(taps), qlp.shape[1]) * qlp.element_size()
