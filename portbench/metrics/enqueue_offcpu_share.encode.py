"""The share of the FLAC encode's host enqueue in which the worker's
thread was off the CPU, %: 1 - ``timings["enqueue_cpu"]`` (the
``atpu.flac_enc.enqueue`` span's thread CPU seconds) over
``timings["enqueue"]`` (its wall-clock seconds), over the window's
tracks.  The thread waits there for the interpreter lock, the caching
allocator or the driver."""


def read(ctx):
    t = ctx.get("encode_timings", {})
    (wall, cpu) = (t.get("enqueue"), t.get("enqueue_cpu"))
    if (ctx["driver"] != "encode" or not ctx["counters"].get(
            "encode_batches") or not wall or cpu is None):
        return None     # another cell, or a program without the span
    return (1.0 - cpu / wall) * 100.0
