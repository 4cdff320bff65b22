"""The share of the traced window, %, in which no kernel, copy or fill
ran on the card, in the seek cells (``torch.profiler``'s timeline)."""


def read(ctx):
    if ctx["driver"] != "seek" or ctx["trace"] is None:
        return None
    t = ctx["trace"]
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
