"""The FLAC encode's floor and overflow retries' exact re-analysis on
the card a batch, ms: ``timings["floor_analysis"]`` (the
``atpu.flac_enc.floor_analysis`` span, from the upload to the fetch, on
the host clock) summed over the window's tracks, over the batches
submitted."""


def read(ctx):
    batches = ctx["counters"].get("encode_batches")
    seconds = ctx.get("encode_timings", {}).get("floor_analysis")
    if ctx["driver"] != "encode" or not batches or seconds is None:
        return None     # another cell, or a program without the span
    return seconds * 1e3 / batches
