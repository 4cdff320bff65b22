"""The cost of the port's stage spans (``utils/profiling``) on the host,
and of ``ATPU_PROFILE`` on the benchmark's FLAC -8 album encode.

    python3 tools_dev/span_cost.py [--device cuda] [--tracks 4] \\
        [--rounds 3] [--seed 7]

Prints JSON lines: the nanoseconds a ``with span(...)`` block costs with
nothing bound and no profile recording (the null context), with a sink
bound, and while a CPU profile records, and a ``collect`` binding; the
microseconds a small operation on ``--device`` takes on a thread of its
own, unprofiled and under a profile of all threads (the benchmark's
tracer's) inside 0, 1 and 3 ranges; then
the album encode's Msamples/s (the configuration ``flac8_cd16``'s first
``--tracks`` tracks, on the farm's two workers, as the benchmark runs
them) with ``ATPU_PROFILE`` unset and set in turns: unset, set, set,
unset, ... for ``--rounds`` pairs.  Run it from the root of a checkout.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from audiotools_tpu_torch.utils import profiling  # noqa: E402


def ns_per(block, n):
    t0 = time.perf_counter_ns()
    block(n)
    return (time.perf_counter_ns() - t0) / n


def spans(n):
    for _ in range(n):
        with profiling.span("x", "probe"):
            pass


def bindings(n):
    sink = profiling.StageTimers("probe", "probe")
    for _ in range(n):
        with profiling.collect(sink):
            pass


def span_costs(n):
    os.environ.pop("ATPU_PROFILE", None)
    out = {"loop_ns": ns_per(lambda k: [None for _ in range(k)], n),
           "null_span_ns": ns_per(spans, n),
           "collect_ns": ns_per(bindings, n)}
    with profiling.collect(profiling.StageTimers("probe", "probe")):
        out["bound_span_ns"] = ns_per(spans, n)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["recording_span_ns"] = ns_per(spans, n // 10)
    return out


def op_costs(device, n):
    """µs an operation of a loop of small ones on ``device`` on a worker
    thread: unprofiled, then under an all-threads profile within 0, 1
    and 3 ranges"""
    import threading
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(16, device=device)
    out = {}

    def loop(depth, key):
        with contextlib.ExitStack() as stack:
            for d in range(depth):
                stack.enter_context(profiling.span("probe%d" % d, "probe"))
            for _ in range(n // 10):        # warm
                x.add_(1)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(n):
                x.add_(1)
            torch.cuda.synchronize(device)
            out[key] = (time.perf_counter() - t0) / n * 1e6

    def on_thread(depth, key):
        thread = threading.Thread(target=loop, args=(depth, key))
        thread.start()
        thread.join()

    on_thread(0, "op_us_unprofiled")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    for depth in (0, 1, 3):
        with profile(activities=activities, experimental_config=config):
            on_thread(depth, "op_us_traced_in_%d_ranges" % depth)
    return out


def album_rate(album, tracks, device, options, config):
    from audiotools_tpu_torch.parallel import farm
    from portbench.drivers.common import reader
    from audiotools_tpu_torch.codecs.flac_enc_fast import encode_flac_fast

    def run(i, dev):
        samples = album.track(i)
        encode_flac_fast(io.BytesIO(), reader(samples, config), device=dev,
                         **options)
        return samples.size

    t0 = time.perf_counter()
    outcomes = farm.run_jobs(list(range(tracks)), run, workers=2,
                             devices=[device])
    seconds = time.perf_counter() - t0
    for (_r, error) in outcomes:
        if error is not None:
            raise error
    return sum(r for (r, _e) in outcomes) / seconds / 1e6


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tracks", type=int, default=4)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--spans", type=int, default=200000)
    p.add_argument("--ops", type=int, default=20000)
    args = p.parse_args(argv)
    for name in [n for n in os.environ if n.startswith("ATPU_")]:
        del os.environ[name]
    print(json.dumps(dict(span_costs(args.spans),
                          python=sys.version.split()[0],
                          torch=torch.__version__)), flush=True)
    if torch.device(args.device).type == "cuda":
        print(json.dumps(op_costs(args.device, args.ops)), flush=True)
    from portbench.harness import album as album_mod, cells
    config = cells.load_json("configs", "flac8_cd16.json")
    album = album_mod.make_album(torch, config, args.seed, args.device)
    options = dict(config["encode"])
    album_rate(album, 1, args.device, options, config)      # warm-up
    order = []
    for r in range(args.rounds):
        order += [False, True] if r % 2 == 0 else [True, False]
    for profiled in order:
        if profiled:
            os.environ["ATPU_PROFILE"] = "1"
        else:
            os.environ.pop("ATPU_PROFILE", None)
        with contextlib.redirect_stderr(io.StringIO()):
            rate = album_rate(album, args.tracks, args.device, options,
                              config)
        print(json.dumps({"ATPU_PROFILE": int(profiled),
                          "encode_Msamples_s": rate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
