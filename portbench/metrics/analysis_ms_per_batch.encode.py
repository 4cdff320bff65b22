"""The FLAC encode's analysis a batch, ms: ``timings["analysis"]`` (CUDA
events around the analysis on the card, the host's enqueue included)
summed over the window's tracks, over the batches submitted (full and
final partial ones)."""


def read(ctx):
    batches = ctx["counters"].get("encode_batches")
    if ctx["driver"] != "encode" or not batches:
        return None
    return ctx["encode_timings"].get("analysis", 0.0) * 1e3 / batches
