"""The card memory the encode's window allocated at its peak, GB:
``torch.cuda.max_memory_allocated()`` after a reset at the window's
start."""


def read(ctx):
    if ctx["driver"] != "encode" or not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 1e9
