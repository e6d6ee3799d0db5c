"""A cell of BENCHMARK.json and the files that belong to it, found by name.

A workload names a configuration (its `file`, a JSON of sizes) and a
traffic mix (`hebench/traffic/<traffic>.json`), whose `kind` is the loop
that drives it (`hebench/kinds/<kind>.py`) and whose operations are each
`hebench/ops/<scheme>.<op>.py`; the limits its numbers are compared with
are in `hebench/limits/<workload>.json`; each per-layer metric is read by
`hebench/metrics/<metric>.py`.  Which end-to-end and per-layer metrics a
cell reports is what BENCHMARK.json lists for it.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One workload: its configuration, mix, limits and the metrics it
    reports (each a BENCHMARK.json entry)."""

    def __init__(self, name: str, chips: int, config: dict, traffic: dict,
                 limits: dict, end_to_end: list, per_layer: list):
        self.name, self.chips = name, chips
        self.config, self.traffic, self.limits = config, traffic, limits
        self.end_to_end, self.per_layer = end_to_end, per_layer

    @classmethod
    def load(cls, workload: str, root: str = ROOT) -> "Cell":
        bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        return cls(workload, w["chips"],
                   _json(os.path.join(root, conf["file"])),
                   _json(os.path.join(HERE, "traffic",
                                      w["traffic"] + ".json")),
                   _json(os.path.join(HERE, "limits", workload + ".json")),
                   [m for m in bench["end_to_end"] if _reports(m, workload)],
                   [m for m in bench["per_layer"] if _reports(m, workload)])


@functools.lru_cache(maxsize=None)
def _module(folder: str, name: str):
    """hebench/<folder>/<name>.py, loaded from its path (names hold dots)."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"hebench.{folder}." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(trace)` function of hebench/metrics/<metric>.py."""
    return _module("metrics", metric).read


def op(scheme: str, name: str):
    """The operation `name` of `scheme`: hebench/ops/<scheme>.<name>.py."""
    return _module("ops", f"{scheme}.{name}")


def kind(name: str):
    """The `Mix` class of the traffic kind `name`: hebench/kinds/<name>.py."""
    return _module("kinds", name).Mix
