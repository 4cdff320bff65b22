"""wv_corr's share of its bound in the WavPack encode, %: the least time
its launches need over its device time in the traced window (the
kernels named ``wv_chain_kernel<true>``).

``wv_corr`` runs serial recurrences, so bytes alone do not bound it: a
standard stereo block moves about 1.4 MB, 0.42 us at 3.35 TB/s, against
milliseconds of kernel.  A launch's bound is the larger of its bytes
over the card's bandwidth (each input byte read once and each output
byte written once, from the launch's tensors: ``launch_bytes_moved``)
and its serial floor (``serial_floor_s``): the longest block's samples
times the slowest pass's dependent chain, 60.63 cycles a step (measured
by ``tools_dev/int_op_cycles.py`` on the card, PERF.md section 6), at
the card's 1980 MHz boost clock, plus the pipeline's fill of (passes -
1) chunks.  The harness sums what ``launch_bytes`` returns and divides
it by the bandwidth, so ``launch_bytes`` returns the bound times the
bandwidth: bytes that take the bound's time."""

# the port's binding whose launches are counted
KERNEL = ("audiotools_tpu_torch.kernels", "wv_corr")
# the kernels in the trace that it launches (csrc/wv_chain.cu's encoder)
NAMES = ("wv_chain_kernel<true>",)
# the card's peak bandwidth (the harness's), bytes a second
PEAK_BYTES_PER_S = 3.35e12
# the slowest pass's dependent chain, cycles a step, and the clock
CHAIN_CYCLES = 60.63
CLOCK_HZ = 1.98e9
# samples a ring chunk holds where the program does not say
DEFAULT_CHUNK = 16


def read(ctx):
    if ctx["driver"] != "wv_encode" or ctx["trace"] is None:
        return None
    seconds = sum(v["seconds"] for (name, v) in ctx["trace"]["kernels"].items()
                  if any(n in name for n in NAMES))
    bound = (ctx["kernel_bytes"] or {}).get("wv_corr", 0)
    if not seconds or not bound:
        return None
    return bound / ctx["peak_bytes_per_s"] / seconds * 100.0


def launch_bytes_moved(args):
    """wv_corr(x, meta, chain, weights, samples, out, w_out, s_out): every
    tensor read or written once"""
    return sum(t.numel() * t.element_size() for t in args)


def chunk_samples():
    """the samples of a ring chunk the program's kernel was built with
    (read once)"""
    if not _CHUNK:
        try:
            from audiotools_tpu_torch import kernels
            _CHUNK.append(int(kernels.wv_chain_config()[0]))
        except (ImportError, AttributeError, OSError, RuntimeError):
            # no kernel library to ask (no card, no nvcc)
            _CHUNK.append(DEFAULT_CHUNK)
    return _CHUNK[0]


_CHUNK = []


def serial_floor_s(meta, chunk):
    """the serial floor of a launch, seconds, from its blocks' (offset,
    n, cc, passes) rows: the longest block's steps and the fill"""
    longest = max((int(n) for (_o, n, _c, _p) in meta), default=0)
    passes = max((int(p) for (_o, _n, _c, p) in meta), default=0)
    steps = longest + max(passes - 1, 0) * chunk
    return steps * CHAIN_CYCLES / CLOCK_HZ


def launch_bytes(args, _seen):
    """the launch's bound times the bandwidth (module docstring); reads
    its block table back to the host"""
    floor = serial_floor_s(args[1].tolist(), chunk_samples())
    return max(launch_bytes_moved(args), floor * PEAK_BYTES_PER_S)
