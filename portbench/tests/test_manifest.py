"""BENCHMARK.json against the contract, and discovery by name."""

import copy
import json
import os

import pytest

from conftest import ROOT
from harness.manifest import Bench, ManifestError, validate


@pytest.fixture
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_committed_manifest_is_valid(manifest):
    validate(manifest)


def test_every_name_is_found_by_name():
    b = Bench(ROOT)
    for cell in b.m["workloads"]:
        cfg, traffic, limits = b.config(cell), b.traffic(cell), b.limits(cell)
        assert cfg["name"] == cell["config"]
        assert traffic["call_metric"] in {e["name"] for e in
                                          b.end_to_end(cell["name"])}
        assert limits and all(v >= 0 for v in limits.values())
        for m in b.per_layer(cell["name"]):
            assert callable(b.reader(m["name"]))


@pytest.mark.parametrize("edit, what", [
    (lambda m: m["workloads"][0].update(name="has space"), "name"),
    (lambda m: m["workloads"][0].update(name="a/b"), "name"),
    (lambda m: m["end_to_end"][0].update(unit="seconds per fit"), "unit"),
    (lambda m: m["end_to_end"][0].update(unit="x" * 17), "unit"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["end_to_end"][0].update(source="program_span"), "source"),
    (lambda m: m["per_layer"][0].update(moves="nope"), "moves"),
    (lambda m: m["per_layer"][0].update(why="extra key"), "keys"),
    (lambda m: m.update(run_seconds=52), "run_seconds"),
    (lambda m: m["workloads"][1].update(config=m["workloads"][0]["config"],
                                        traffic=m["workloads"][0]["traffic"]),
     "pair"),
    (lambda m: m["command"].append("/abs/path"), "command"),
    (lambda m: m.update(end_to_end=[e for e in m["end_to_end"]
                                    if e["name"] != "setup_s"]), "setup_s"),
])
def test_contract_breaches_are_refused(manifest, edit, what):
    m = copy.deepcopy(manifest)
    edit(m)
    with pytest.raises(ManifestError):
        validate(m)


def test_units_and_names_within_limits(manifest):
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        assert 1 <= len(e["unit"]) <= 16
        assert len(e["name"]) <= 64
