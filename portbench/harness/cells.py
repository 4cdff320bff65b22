"""What BENCHMARK.json says of a cell, and the files it names: the
configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``), the driver the mix names
(``drivers/<driver>.py``) and each per-layer metric's reader
(``metrics/<metric>.py``), all found by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)


def load_benchmark(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


class Cell:
    """one workload of BENCHMARK.json with its configuration, its mix and
    the metrics it reports"""

    def __init__(self, bench, workload):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError("no workload %r in BENCHMARK.json" % (workload,))
        self.entry = cells[workload]
        self.name = workload
        self.chips = self.entry["chips"]
        config = {c["name"]: c for c in bench["configs"]}[
            self.entry["config"]]
        self.config = load_json("configs", self.entry["config"] + ".json")
        if config["file"] != "portbench/configs/%s.json" % (config["name"],):
            raise ValueError("configuration file %r is not where the "
                             "harness looks" % (config["file"],))
        self.mix = load_json("traffic", self.entry["traffic"] + ".json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]


# a driver's name is a module name under drivers/
DRIVER_NAME = re.compile(r"^[a-z_][a-z0-9_]*$")


def driver_class(name):
    """the driver a mix names: ``drivers/<name>.py``'s ``Driver``"""
    if not DRIVER_NAME.match(name) or name == "common":
        raise ValueError("no driver %r" % (name,))
    return importlib.import_module("portbench.drivers." + name).Driver


def metric_module(name):
    """per-layer metric ``name``'s file, ``metrics/<name>.py``: its
    ``read(ctx)`` returns a number or None; a roofline's file also names
    the kernel binding whose launches it counts bytes of (``KERNEL``,
    ``launch_bytes``)"""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

