"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven as it
is. One case per fault the cells can have (there is no exchange between
chips: every cell runs on one)."""

import time

import numpy as np
import pytest
import torch

import harmonypy_tpu_torch.api as api
import harmonypy_tpu_torch.engine as engine
import harmonypy_tpu_torch.lisi as lisi_mod
import harmonypy_tpu_torch.ops.update_r_fused as urf
import control
from harness.manifest import Bench
from harness.session import run_cell


def _run(root, workload):
    torch.set_num_threads(2)
    return run_cell(Bench(root), workload, 99, 0.5, False,
                    time.perf_counter(), device="cpu", require_cards=False)


def _step_unchanged(mp):
    mp.setattr(engine.HarmonyStep, "__call__", lambda self, st: None)


def _half_the_cells(mp):
    """Every block's E-step drops its second half of chunks: their cells'
    assignments zero, the statistics taken over the rest."""
    core = urf.block_core

    def half(O, E, rem_b, slots_b, *a, **k):
        out = list(core(O, E, rem_b, slots_b, *a, **k))
        out[2] = out[2].clone()
        out[2][out[2].shape[0] // 2:] = 0.0
        return tuple(out)
    mp.setattr(urf, "block_core", half)


def _answer_altered(mp):
    """One value of Z_corr changed where the API produces it."""
    prop = api.Harmony.Z_corr

    def z(self):
        out = prop.fget(self).copy()
        out[len(out) // 3, 1] += 0.5
        return out
    mp.setattr(api.Harmony, "Z_corr", property(z))


def _intercept_kept(mp):
    """The ridge's intercept row solved and applied with the batch rows,
    not zeroed: a shift common to every batch of a cluster."""
    control.keep_intercept(mp.setattr)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_the_cells,
                                   _answer_altered, _intercept_kept])
def test_fit_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tiny_root, "tiny.fit")
    assert not r["correct"], r["checks"]


def _neighbour_dropped(mp):
    """The kNN answers one neighbour short of exact: the nearest is
    replaced by the next."""
    knn = lisi_mod._knn_batched

    def shifted(*a, **k):
        d, i = knn(*a, **k)
        return torch.cat([d[:, 1:], d[:, -1:]], 1), \
            torch.cat([i[:, 1:], i[:, -1:]], 1)
    mp.setattr(lisi_mod, "_knn_batched", shifted)


def _lisi_altered(mp):
    """Every Simpson index moved by one part in a million where
    compute_lisi produces it."""
    simpson = lisi_mod._simpson_label

    def altered(*a, **k):
        s = simpson(*a, **k).clone()
        s *= 1.0 + 1e-6
        return s
    mp.setattr(lisi_mod, "_simpson_label", altered)


@pytest.mark.parametrize("fault", [_neighbour_dropped, _lisi_altered])
def test_lisi_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tiny_root, "tiny.lisi")
    assert not r["correct"], r["checks"]
