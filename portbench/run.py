"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout.  It makes its inputs from the seed,
warms up, measures for the given seconds (with ``--trace 1`` a shorter
traced window and the per-layer metrics), checks what the window
produced against the plain reference in ``portbench/reference``, prints
each number compared beside its limit as its last lines on standard
error, and prints the result as one JSON object on the last line of
standard output.  It exits non-zero, printing no result, where no CUDA
card is usable or fewer than the cell asks for, and where JAX or the
JAX package was loaded.
"""

import time

SETUP_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv):
    args = parse(argv)
    # the program runs as the configuration states: none of its ATPU_*
    # switches
    for name in [n for n in os.environ if n.startswith("ATPU_")]:
        del os.environ[name]
    sys.path.insert(0, ROOT)
    from portbench.harness import cells, core
    core.prepare_caches(ROOT)
    cell = cells.Cell(cells.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available():
        core.log("no usable CUDA card: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        core.log("the cell asks for %d cards, %d exist"
                 % (cell.chips, torch.cuda.device_count()))
        return 2
    (result, notes) = core.run_cell(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    t0=SETUP_START)
    found = core.forbidden_modules()
    if found:
        core.log("forbidden modules loaded: " + ", ".join(found))
        return 3
    result["device"]["power_limit"] = power_limit()
    for (key, value) in notes.items():
        core.log("%s: %s" % (key, json.dumps(value)))
    for (name, check) in result["checks"].items():
        core.log("check %s = %s (limit %s)" % (name, check["value"],
                                               check["limit"]))
    print(json.dumps(result), flush=True)
    return 0


def power_limit():
    """the card's name and power limit from nvidia-smi, or None"""
    import subprocess
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else None


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
