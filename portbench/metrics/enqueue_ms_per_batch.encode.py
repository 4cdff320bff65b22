"""The FLAC encode's host enqueue a batch, ms: ``timings["enqueue"]``
(the ``atpu.flac_enc.enqueue`` span: the host's time to enqueue the
wire's unpack, the analysis and ``compact_decisions``, the pinned upload
left out) summed over the window's tracks, over the batches submitted."""


def read(ctx):
    batches = ctx["counters"].get("encode_batches")
    seconds = ctx.get("encode_timings", {}).get("enqueue")
    if ctx["driver"] != "encode" or not batches or seconds is None:
        return None     # another cell, or a program without the span
    return seconds * 1e3 / batches
