"""The FLAC encode's host stages a batch, ms: ``timings`` qpack (the
wire's C++ scan), emit and floor (host clock around the C++ calls),
summed over the window's tracks, over the batches submitted."""


def read(ctx):
    batches = ctx["counters"].get("encode_batches")
    if ctx["driver"] != "encode" or not batches:
        return None
    t = ctx["encode_timings"]
    return sum(t.get(k, 0.0) for k in ("qpack", "emit", "floor")) * 1e3 \
        / batches
