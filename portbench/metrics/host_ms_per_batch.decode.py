"""The FLAC decode's host stages a batch, ms: ``TorchFlacDecoder.timings``
scan, prep and md5 (host clock), summed over the window's tracks, over
the device batches decoded (one ``flac_synth`` launch each)."""


def read(ctx):
    batches = ctx["counters"].get("decode_batches")
    if ctx["driver"] != "decode" or not batches:
        return None
    t = ctx["decode_timings"]
    return sum(t.get(k, 0.0) for k in ("scan", "prep", "md5")) * 1e3 \
        / batches
