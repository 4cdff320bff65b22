"""The FLAC decode's host enqueue a batch, ms: ``TorchFlacDecoder.timings``
enqueue (the ``atpu.flac_dec.enqueue`` span: the upload from fresh
pinned memory and the launches of the device stages, on the host clock)
summed over the window's tracks, over the device batches decoded (one
``flac_synth`` launch each)."""


def read(ctx):
    batches = ctx["counters"].get("decode_batches")
    seconds = ctx.get("decode_timings", {}).get("enqueue")
    if ctx["driver"] != "decode" or not batches or seconds is None:
        return None     # another cell, or a program without the span
    return seconds * 1e3 / batches
