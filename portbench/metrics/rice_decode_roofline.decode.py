"""rice_decode's share of its roofline in the FLAC decode, %: the least
time its bytes need at the card's peak bandwidth (each input byte read
once and each output byte written once, counted from each launch's
tensors by ``launch_bytes`` below) over its device time in the
traced window (the kernels named ``rice_direct_kernel`` and ``rice_staged_kernel``)."""

# the port's binding whose launches' bytes are counted
KERNEL = ("audiotools_tpu_torch.kernels", "rice_decode")
# the kernels in the trace that it launches
NAMES = ('rice_direct_kernel', 'rice_staged_kernel')


def read(ctx):
    if ctx["driver"] != "decode" or ctx["trace"] is None:
        return None
    seconds = sum(v["seconds"] for (name, v) in ctx["trace"]["kernels"].items()
                  if any(n in name for n in NAMES))
    moved = (ctx["kernel_bytes"] or {}).get("rice_decode", 0)
    if not seconds or not moved:
        return None
    return moved / ctx["peak_bytes_per_s"] / seconds * 100.0


def launch_bytes(args, seen):
    """rice_decode(words, word_base, base_bits, k, raw_bits, count, W,
    out): the records' five int32 fields and the decoded codes once,
    and the batch's compressed words once a batch (every bucket's launch
    reads from the same words)"""
    (words, word_base, base_bits, k, raw_bits, count, _W, out) = args
    n = sum(t.numel() * t.element_size()
            for t in (word_base, base_bits, k, raw_bits, count, out))
    if seen.get(id(words)) is not words:
        seen[id(words)] = words
        n += words.numel() * words.element_size()
    return n
