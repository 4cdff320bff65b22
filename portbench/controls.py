"""The readings behind each cell's limits, run apart from the benchmark's
own runs, on the card, a seed after another in one process:

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3 \\
        --jobs <n> [--program-seconds <s>]

For each seed it prints one JSON line with the cell's checks:

* ``control``: the cell's set-up as a run makes it (the album from the
  seed, the decode cells' files written by the program), then the first
  ``--jobs`` jobs or requests of the window made by the control, the
  plain reference in the program's place computed in float32 (the
  encoder's LPC analysis, the decoder's synthesis), and judged by the
  cell's own check.  It has to come out not correct;
* with ``--program-seconds``, ``program``: a whole run of the cell in
  this process (set-up, a window of that many seconds, the check), the
  program's reading on the same seed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_reading(root, workload, seed, jobs, device, **overrides):
    """the cell's checks of the control's records: ([(name, value,
    limit)], the check's counts)"""
    import torch

    from portbench.harness import cells, core
    cell = cells.Cell(cells.load_benchmark(root), workload)
    if device == "cuda":
        core.build_program(root)
    workdir = tempfile.mkdtemp(prefix="portbench-controls-")
    try:
        env = core.Env(torch, cell, seed, torch.device(device, 0)
                       if device == "cuda" else torch.device(device),
                       workdir, **overrides)
        driver = core.make_driver(env)
        driver.setup()
        records = driver.control(jobs)
        driver.release()
        return driver.check(records)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def line(kind, workload, seed, checks, counts, t0):
    return {"kind": kind, "workload": workload, "seed": seed,
            "correct": all(v <= limit for (_n, v, limit) in checks),
            "checks": {n: {"value": v, "limit": limit}
                       for (n, v, limit) in checks},
            "counts": counts, "seconds": time.perf_counter() - t0}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--jobs", type=int, required=True)
    p.add_argument("--program-seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness import core
    core.prepare_caches(ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        if args.program_seconds:
            t0 = time.perf_counter()
            (result, notes) = core.run_cell(ROOT, args.workload, seed,
                                            args.program_seconds, False)
            checks = [(n, c["value"], c["limit"])
                      for (n, c) in result["checks"].items()]
            counts = {k: v for (k, v) in notes.items()
                      if k.endswith(("_checked", "_differing", "_missing",
                                     "_misplaced", "_records"))}
            counts["end_to_end"] = notes["end_to_end"]
            print(json.dumps(line("program", args.workload, seed, checks,
                                  counts, t0)), flush=True)
        t0 = time.perf_counter()
        (checks, counts) = control_reading(ROOT, args.workload, seed,
                                           args.jobs, "cuda")
        print(json.dumps(line("control", args.workload, seed, checks,
                              counts, t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
