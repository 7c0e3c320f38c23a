"""A cell of BENCHMARK.json and the files that it names, found by name.

A cell (`workloads` entry) names a configuration, whose `file` holds the
deck, and a traffic mix, `traffic/<mix>.json` beside this package; its
limits are `limits/<cell>.json`, and each per-layer metric is read by
`metrics/<metric>.py`, whose `read(art)` returns the metric's value from a
traced run's artifacts, or None where it finds nothing to read.  A later
cell, mix or metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # traffic/<mix>.json
    limits: dict          # limits/<cell>.json: check name -> limit
    end_to_end: list      # BENCHMARK.json's entries that this cell reports
    per_layer: list


def _reports(metric, cell, e2e_names):
    """Whether a metric's entry applies to `cell`: its `workloads`, else
    (a per-layer metric) every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name, bench=None):
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(BENCH, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(BENCH, "limits", name + ".json")),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if _reports(m, name, names)])


def data_path(rel):
    """A path of a configuration's file, relative to benchmarks/."""
    return os.path.join(BENCH, rel)


def reader(metric):
    """`read` of metrics/<metric>.py."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
