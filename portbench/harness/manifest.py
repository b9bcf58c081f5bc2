"""BENCHMARK.json: loading, validation and discovery by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in a file of its own, found by its name:

  <paths[0]>/configs/<config>.json   (the `file` of its entry)
  <paths[0]>/traffic/<traffic>.json
  <paths[0]>/metrics/<metric>.py     (a per-layer reader: read(run))
  <paths[0]>/limits/<workload>.json  (the correctness limits of a cell)

so a later change adds a cell, a configuration or a metric by adding
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class ManifestError(ValueError):
    pass


def _line(s, what):
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s \
            or "\t" in s:
        raise ManifestError(f"{what}: 1 to 200 characters on one line, "
                            f"no tab: {s!r}")


def _name(s, what):
    if not isinstance(s, str) or not NAME.match(s):
        raise ManifestError(f"{what}: not a name: {s!r}")


def _keys(entry, allowed, what, optional=()):
    keys = set(entry)
    if not allowed <= keys or not keys <= allowed | set(optional):
        raise ManifestError(f"{what}: keys {sorted(keys)}, expected "
                            f"{sorted(allowed)} (+ {sorted(optional)})")


def validate(m: dict) -> None:
    """Raise ManifestError where m breaks the benchmark's contract."""
    if set(m) != TOP_KEYS:
        raise ManifestError(f"top-level keys {sorted(m)}")
    if not (isinstance(m["command"], list) and 1 <= len(m["command"]) <= 32):
        raise ManifestError("command: a list of 1 to 32 strings")
    for w in m["command"]:
        _line(w, "command word")
        if w.startswith("/") or ".." in w.split("/"):
            raise ManifestError(f"command word leaves the repo: {w!r}")
    if not (isinstance(m["paths"], list) and 1 <= len(m["paths"]) <= 16):
        raise ManifestError("paths: 1 to 16 directories")
    for p in m["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            raise ManifestError(f"path {p!r}")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and not isinstance(rs, bool)
            and 1 <= rs <= 51):
        raise ManifestError("run_seconds: a whole number from 1 to 51")
    names = set()

    def unique(n):
        if n in names:
            raise ManifestError(f"name {n!r} used twice")
        names.add(n)

    if not 1 <= len(m["configs"]) <= 24:
        raise ManifestError("configs: 1 to 24")
    files = set()
    for c in m["configs"]:
        _keys(c, CONFIG_KEYS, "config")
        _name(c["name"], "config name")
        unique(c["name"])
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        if c["file"] in files or not any(
                c["file"].startswith(p.rstrip("/") + "/") for p in m["paths"]):
            raise ManifestError(f"config file {c['file']!r}")
        files.add(c["file"])
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise ManifestError("reduced: a list of at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
    configs = {c["name"] for c in m["configs"]}
    if not 1 <= len(m["workloads"]) <= 24:
        raise ManifestError("workloads: 1 to 24")
    pairs, cells = set(), set()
    for w in m["workloads"]:
        _keys(w, CELL_KEYS, "workload")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        unique(w["name"])
        _line(w["why"], "workload why")
        if w["config"] not in configs or w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: config or chips")
        if (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"pair {w['config']}/{w['traffic']} twice")
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    used = {w["config"] for w in m["workloads"]}
    if used != configs:
        raise ManifestError(f"configs without a cell: {configs - used}")
    four = sum(w["chips"] == 4 for w in m["workloads"])
    if four > max(1, len(m["workloads"]) // 4):
        raise ManifestError("too many four-chip cells")
    if not 1 <= len(m["end_to_end"]) <= 16:
        raise ManifestError("end_to_end: 1 to 16")
    e2e = {}
    for e in m["end_to_end"]:
        _keys(e, E2E_KEYS, "end_to_end metric", ("workloads",))
        _metric(e, unique, cells)
        if e["source"] not in ("host_clock", "device_trace"):
            raise ManifestError(f"{e['name']}: end-to-end source")
        b = e["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            raise ManifestError(f"{e['name']}: bound {b}")
        e2e[e["name"]] = set(e.get("workloads", cells))
    if "setup_s" not in e2e:
        raise ManifestError("no setup_s")
    if not 1 <= len(m["per_layer"]) <= 128:
        raise ManifestError("per_layer: 1 to 128")
    for p in m["per_layer"]:
        _keys(p, LAYER_KEYS, "per-layer metric", ("workloads",))
        _metric(p, unique, cells)
        _line(p["layer"], "layer")
        if p["moves"] not in e2e:
            raise ManifestError(f"{p['name']} moves {p['moves']!r}")
        if not set(p.get("workloads", cells)) <= e2e[p["moves"]]:
            raise ManifestError(f"{p['name']}: a cell that does not report "
                                f"{p['moves']}")
    for w in cells:
        mine = [n for n, ws in e2e.items() if w in ws]
        if "setup_s" not in mine or len(mine) < 2:
            raise ManifestError(f"{w}: setup_s and one more end-to-end "
                                f"metric")
        if not any(w in p.get("workloads", cells) for p in m["per_layer"]):
            raise ManifestError(f"{w}: no per-layer metric")


def _metric(e, unique, cells):
    _name(e["name"], "metric name")
    unique(e["name"])
    if not isinstance(e["unit"], str) or not UNIT.match(e["unit"]):
        raise ManifestError(f"{e['name']}: unit {e['unit']!r}")
    if e["better"] not in ("lower", "higher"):
        raise ManifestError(f"{e['name']}: better")
    if e["source"] not in SOURCES:
        raise ManifestError(f"{e['name']}: source")
    ws = e.get("workloads", cells)
    if not ws or not set(ws) <= cells:
        raise ManifestError(f"{e['name']}: workloads {ws}")


class Bench:
    """A validated BENCHMARK.json at `root` and what it names."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "BENCHMARK.json")
        with open(path) as f:
            self.m = json.load(f)
        validate(self.m)
        self.home = os.path.join(root, self.m["paths"][0])

    def cell(self, workload: str) -> dict:
        for w in self.m["workloads"]:
            if w["name"] == workload:
                return w
        raise ManifestError(f"no workload {workload!r}")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.m["configs"]
                     if c["name"] == cell["config"])
        return _json(os.path.join(self.root, entry["file"]))

    def traffic(self, cell: dict) -> dict:
        return _json(os.path.join(self.home, "traffic",
                                  cell["traffic"] + ".json"))

    def limits(self, cell: dict) -> dict:
        return _json(os.path.join(self.home, "limits",
                                  cell["name"] + ".json"))

    def _applies(self, metric: dict, workload: str) -> bool:
        return workload in metric.get(
            "workloads", [w["name"] for w in self.m["workloads"]])

    def end_to_end(self, workload: str) -> list:
        return [e for e in self.m["end_to_end"] if self._applies(e, workload)]

    def per_layer(self, workload: str) -> list:
        return [p for p in self.m["per_layer"] if self._applies(p, workload)]

    def reader(self, metric: str):
        """The read(run) function of metrics/<metric>.py."""
        path = os.path.join(self.home, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
