"""The WavPack encode's host stages a frame, ms: ``timings`` read (the
PCM read), md5, decide (``begin_block``: the false-stereo, wasted-bits
and joint-stereo decisions) and write (``end_block``: the sub-blocks,
the residual coder and the CRC), each an ``atpu.wv_enc.<stage>`` span on
the host clock, summed over the window's tracks, over the frames
encoded (``codecs/wavpack.frames_encoded``)."""

STAGES = ("read", "md5", "decide", "write")


def read(ctx):
    frames = ctx["counters"].get("wv_frames_encoded")
    t = ctx.get("wv_encode_timings", {})
    if (ctx["driver"] != "wv_encode" or not frames or
            any(stage not in t for stage in STAGES)):
        return None     # another cell, or a program without the spans
    return sum(t[stage] for stage in STAGES) * 1e3 / frames
