"""The WavPack encode's correlation a frame, ms: ``timings["correlate"]``
(the ``atpu.wv_enc.correlate`` span around the whole ``correlate`` call,
host clock: the pack, the upload, the ``wv_corr`` launch, the worker's
wait for the card and the fetch, and the weights and samples carried
back into the next block's state) summed over the window's tracks, over
the frames encoded (``codecs/wavpack.frames_encoded``)."""


def read(ctx):
    frames = ctx["counters"].get("wv_frames_encoded")
    seconds = ctx.get("wv_encode_timings", {}).get("correlate")
    if ctx["driver"] != "wv_encode" or not frames or seconds is None:
        return None     # another cell, or a program without the span
    return seconds * 1e3 / frames
