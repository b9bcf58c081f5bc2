"""The port's file loading, CLI, scanpy helper and capacity preflight on
the CPU: the cases of tests/test_io.py against the JAX package's
load_matrix on the same files, `python -m harmonypy_tpu_torch correct` and
`lisi` on the pbmc fixture (golden r >= 0.99), harmony_integrate on an
AnnData-like object, CapacityError under HARMONYPY_DEVICE_MEM_BYTES and
the envelope's ordering."""

import gzip
import os
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

from harmonypy_tpu.io import load_matrix as jax_load_matrix
import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.__main__ import main as cli_main
from harmonypy_tpu_torch.config import EngineConfig
from harmonypy_tpu_torch.integrate import harmony_integrate
from harmonypy_tpu_torch.io import load_matrix, load_matrix_tsv
from harmonypy_tpu_torch.utils.memory import (CapacityError, check_capacity,
                                              memory_envelope)
from test_torch_fit import REPO, _problem


def _same_as_jax(path, out, rows=None):
    np.testing.assert_array_equal(out, jax_load_matrix(path, rows=rows))


@pytest.fixture(scope="module")
def tsv_file(tmp_path_factory):
    rng = np.random.default_rng(42)
    X = rng.normal(size=(533, 7)).astype(np.float32) * 10
    path = tmp_path_factory.mktemp("io") / "m.tsv.gz"
    hdr = "\t".join(f"PC{i}" for i in range(7))
    rows = "\n".join("\t".join(f"{v:.6f}" for v in r) for r in X)
    with gzip.open(path, "wt") as f:
        f.write(hdr + "\n" + rows + "\n")
    return str(path), X


def test_tsv_roundtrip(tsv_file):
    path, X = tsv_file
    out = load_matrix_tsv(path)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, X, rtol=1e-6, atol=1e-6)
    _same_as_jax(path, load_matrix(path))


def test_tsv_row_range(tsv_file):
    path, X = tsv_file
    out = load_matrix_tsv(path, rows=(100, 250))
    np.testing.assert_allclose(out, X[100:250], rtol=1e-6, atol=1e-6)
    assert load_matrix_tsv(path, rows=(530, 999)).shape == (3, 7)
    _same_as_jax(path, load_matrix(path, rows=(100, 250)), rows=(100, 250))


def test_tsv_rownames_and_plain(tmp_path):
    """A leading string column is dropped; plain (non-gz) files and
    scientific notation parse."""
    X = np.array([[1.5e-3, -2.0], [3e4, 0.25], [-1.0, 7.0]], np.float32)
    path = tmp_path / "named.tsv"
    with open(path, "w") as f:
        f.write("cell\ta\tb\n")
        for i, r in enumerate(X):
            f.write(f"cell{i}\t{r[0]:e}\t{r[1]}\n")
    out = load_matrix_tsv(str(path))
    np.testing.assert_allclose(out, X, rtol=1e-6)
    _same_as_jax(str(path), load_matrix(str(path)))


def test_npy_dispatch(tmp_path):
    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    path = str(tmp_path / "m.npy")
    np.save(path, X)
    np.testing.assert_array_equal(load_matrix(path), X)
    np.testing.assert_array_equal(load_matrix(path, rows=(1, 3)), X[1:3])
    _same_as_jax(path, load_matrix(path, rows=(1, 3)), rows=(1, 3))


def test_csv_dispatch(tmp_path):
    path = str(tmp_path / "m.csv")
    with open(path, "w") as f:
        f.write("a,b\n1.0,2.0\n3.5,-4.0\n")
    out = load_matrix(path)
    np.testing.assert_allclose(out, [[1.0, 2.0], [3.5, -4.0]])
    _same_as_jax(path, out)


def test_headerless_tsv_keeps_first_row(tmp_path):
    X = np.array([[1.5, 2.5], [3.0, 4.0], [5.0, 6.0]], np.float32)
    path = str(tmp_path / "nohdr.tsv")
    with open(path, "w") as f:
        for r in X:
            f.write(f"{r[0]}\t{r[1]}\n")
    np.testing.assert_allclose(load_matrix_tsv(path), X)
    _same_as_jax(path, load_matrix(path))


@pytest.fixture(scope="module")
def corrected(ref_data_dir, tmp_path_factory):
    """`correct` on the pbmc fixture files, on the CPU."""
    out = str(tmp_path_factory.mktemp("cli") / "corrected.npy")
    cli_main(["correct", "--pcs", f"{ref_data_dir}/pbmc_3500_pcs.tsv.gz",
              "--meta", f"{ref_data_dir}/pbmc_3500_meta.tsv.gz",
              "--vars", "donor", "--out", out, "--quiet", "--device", "cpu"])
    return out


def test_cli_correct_golden(corrected, pbmc):
    """The per-PC Pearson r of the CLI's output against the R package's
    harmonized PCs is >= 0.99 (tests/test_harmony_golden.py:33)."""
    _, pcs, harmonized = pbmc
    Z = np.load(corrected)
    assert Z.shape == pcs.shape
    gold = harmonized
    if gold.iloc[:, 0].dtype == "object":
        gold = gold.iloc[:, 1:]
    r = [np.corrcoef(Z[:, i], gold.iloc[:, i].values)[0, 1]
         for i in range(Z.shape[1])]
    assert min(r) >= 0.99, min(r)


def test_cli_lisi(corrected, ref_data_dir, tmp_path):
    """`lisi` on the corrected output: its TSV equals compute_lisi of the
    same array; sampled queries carry their cell_index column."""
    meta_path = f"{ref_data_dir}/pbmc_3500_meta.tsv.gz"
    out = str(tmp_path / "lisi.tsv")
    cli_main(["lisi", "--x", corrected, "--meta", meta_path,
              "--labels", "donor", "--out", out, "--device", "cpu"])
    got = pd.read_csv(out, sep="\t")
    assert list(got.columns) == ["donor"]
    meta = pd.read_csv(meta_path, sep="\t")
    ref = ht.compute_lisi(np.load(corrected), meta, ["donor"], device="cpu")
    np.testing.assert_allclose(got.to_numpy(), ref, rtol=1e-12)
    out2 = str(tmp_path / "lisi_s.tsv")
    cli_main(["lisi", "--x", corrected, "--meta", meta_path, "--labels",
              "donor", "--out", out2, "--device", "cpu", "--sample", "200",
              "--knn", "approx"])
    got2 = pd.read_csv(out2, sep="\t")
    assert list(got2.columns) == ["cell_index", "donor"]
    np.testing.assert_allclose(got2["donor"], ref[got2["cell_index"], 0],
                               rtol=1e-12)


@pytest.mark.parametrize("argv,match", [
    (["bench"], "item 10"),
    (["correct", "--pcs", "p.npy", "--meta", "m.tsv", "--vars", "donor",
      "--coordinator", "localhost:1234"], "item 11b"),
])
def test_cli_unported_exit(argv, match):
    with pytest.raises(SystemExit) as exc:
        cli_main(argv)
    assert match in str(exc.value.code)


def test_cli_without_a_card_raises(tmp_path):
    """No --device means CUDA: without a card the subcommand fails and
    writes nothing (it does not fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    X, meta = _problem(N=300, d=4)
    np.save(tmp_path / "x.npy", X)
    meta.to_csv(tmp_path / "m.tsv", sep="\t", index=False)
    for cmd in (["correct", "--pcs", "x.npy", "--vars", "batch",
                 "--out", "z.npy"],
                ["lisi", "--x", "x.npy", "--labels", "batch"]):
        proc = subprocess.run(
            [sys.executable, "-m", "harmonypy_tpu_torch", *cmd, "--meta",
             "m.tsv"], cwd=tmp_path, capture_output=True, text=True,
            timeout=120, env={**os.environ, "PYTHONPATH": REPO})
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert not (tmp_path / "z.npy").exists()


def test_harmony_integrate_helper():
    X, meta = _problem(N=600, d=5)
    adata = types.SimpleNamespace(obsm={"X_pca": X}, obs=meta)
    ho = harmony_integrate(adata, "batch", device="cpu", verbose=False,
                           max_iter_harmony=2)
    assert adata.obsm["X_pca_harmony"].shape == X.shape
    np.testing.assert_array_equal(adata.obsm["X_pca_harmony"], ho.Z_corr)


def _cfg(N, K, **kw):
    return EngineConfig(N=N, d=29, K=K, B=3, n_devices=1,
                        use_fused_xla=True, **kw)


def test_capacity_error_under_a_memory_cap(monkeypatch):
    """A stored fit over the budget raises CapacityError naming defer_r
    (which fits) and low_memory; run_harmony raises it before any upload;
    HARMONYPY_SKIP_CAPACITY_CHECK lets it run. At K = 200 the stored R
    outweighs the deferred fit's replay buffers."""
    cfg = _cfg(20_000_000, 200)
    deferred = memory_envelope(_cfg(20_000_000, 200, defer_r=True))["total"]
    cap = int(deferred / 0.92) + 1
    assert memory_envelope(cfg)["total"] > cap
    monkeypatch.setenv("HARMONYPY_DEVICE_MEM_BYTES", str(cap))
    with pytest.raises(CapacityError, match="pass defer_r=True") as exc:
        check_capacity(cfg, "cpu")
    assert "low_memory=True" in str(exc.value)
    assert "-device mesh" in str(exc.value)
    check_capacity(_cfg(20_000_000, 200, defer_r=True), "cpu")

    X, meta = _problem(N=3000, d=6)
    monkeypatch.setenv("HARMONYPY_DEVICE_MEM_BYTES", "1000000")
    with pytest.raises(CapacityError):
        ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                       chunk_size=128, max_iter_harmony=1)
    monkeypatch.setenv("HARMONYPY_SKIP_CAPACITY_CHECK", "1")
    ho = ht.run_harmony(X, meta, ["batch"], device="cpu", verbose=False,
                        chunk_size=128, max_iter_harmony=1)
    assert np.all(np.isfinite(ho.Z_corr))


def test_envelope_ordering():
    """At atlas scale and large K the deferred fit models below the stored
    one, and bf16 R below fp32; the CPU has no capacity to check. At K =
    400 even a bf16 R outweighs the deferred fit's replay buffers (about
    4 d N floats more than a stored fit holds)."""
    N, K = 5_000_000, 400
    stored = memory_envelope(_cfg(N, K))["total"]
    bf16 = memory_envelope(_cfg(N, K, r_dtype="bfloat16"))["total"]
    deferred = memory_envelope(_cfg(N, K, defer_r=True))["total"]
    percell = memory_envelope(EngineConfig(N=N, d=29, K=K, B=3,
                                           n_devices=1))["total"]
    assert deferred < bf16 < stored
    assert memory_envelope(EngineConfig(
        N=N, d=29, K=K, B=3, n_devices=1, r_dtype="bfloat16"))["total"] \
        < percell
    check_capacity(_cfg(N, K), "cpu")   # no cap known: no check
