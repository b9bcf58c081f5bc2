"""The port's native TSV parser (harmonypy_tpu_torch/io/native/, built with
make at first use) against pandas and the JAX package's parser
(tests/test_io.py:54-62, 111-144): the bundled pbmc embedding, headerless
and ragged files, row ranges, thread counts, where the library lands, and
the pandas fallback when the build fails."""

import ctypes
import gzip
import logging
import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from harmonypy_tpu.io import load_matrix_tsv as jax_load_matrix_tsv
from harmonypy_tpu.io import native_available as jax_native_available
from harmonypy_tpu_torch.io import (load_matrix, load_matrix_tsv,
                                    native_available)
from harmonypy_tpu_torch.io import loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def native():
    """Every test here needs the port's parser built (g++, make, zlib)."""
    assert native_available(), loader._build_error


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


def test_native_matches_pandas_on_reference_data(ref_data_dir, monkeypatch):
    path = os.path.join(ref_data_dir, "pbmc_3500_pcs.tsv.gz")
    a = load_matrix_tsv(path)
    with monkeypatch.context() as m:                # pandas alone
        m.setattr(loader, "_lib", None)
        m.setattr(loader, "_lib_tried", True)
        b = load_matrix_tsv(path)
    assert a.shape == b.shape == (3500, 30) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_native_equals_jax_parser_bitwise(ref_data_dir):
    assert jax_native_available()
    path = os.path.join(ref_data_dir, "pbmc_3500_pcs.tsv.gz")
    np.testing.assert_array_equal(load_matrix_tsv(path),
                                  jax_load_matrix_tsv(path))


@pytest.mark.parametrize("native_on", [True, False])
def test_headerless_tsv_keeps_first_row(tmp_path, monkeypatch, native_on):
    X = np.array([[1.5, 2.5], [3.0, 4.0], [5.0, 6.0]], np.float32)
    path = tmp_path / "nohdr.tsv"
    with open(path, "w") as f:
        for r in X:
            f.write(f"{r[0]}\t{r[1]}\n")
    if not native_on:
        monkeypatch.setattr(loader, "_lib", None)
        monkeypatch.setattr(loader, "_lib_tried", True)
    np.testing.assert_allclose(load_matrix_tsv(str(path)), X)


def test_ragged_row_rejected_by_native(tmp_path):
    path = tmp_path / "ragged.tsv"
    with open(path, "w") as f:
        f.write("a\tb\n1.0\t2.0\n3.0\t4.0\t5.0\n")
    lib = loader._load_native()
    err = ctypes.create_string_buffer(256)
    h = lib.fasttsv_load(str(path).encode(), 0, err, len(err))
    assert not h, "ragged row should fail native parse"
    assert b"row" in err.value
    assert loader._load_native_tsv(lib, str(path), None, 0) is None


def test_row_range_slices(tsv_file):
    path, X = tsv_file
    np.testing.assert_allclose(load_matrix_tsv(path, rows=(100, 250)),
                               X[100:250], rtol=1e-6, atol=1e-6)
    assert load_matrix_tsv(path, rows=(530, 999)).shape == (3, 7)
    np.testing.assert_array_equal(load_matrix(path, rows=(7, 9)),
                                  load_matrix_tsv(path)[7:9])


def test_thread_counts_agree_bitwise(tsv_file, ref_data_dir):
    for path in (tsv_file[0], os.path.join(ref_data_dir,
                                           "pbmc_3500_pcs.tsv.gz")):
        np.testing.assert_array_equal(load_matrix_tsv(path, n_threads=1),
                                      load_matrix_tsv(path, n_threads=4))


def test_library_lands_in_the_port_build_dir():
    so = loader._so_path()
    assert loader._lib._name == so and os.path.isfile(so)
    assert os.path.dirname(so) == os.path.join(REPO, "harmonypy_tpu_torch",
                                               "build")
    jax_pkg = os.path.join(REPO, "harmonypy_tpu")
    assert not any(f.startswith("libfasttsv")
                   for _, _, files in os.walk(jax_pkg) for f in files)


def test_failed_build_falls_back_to_pandas(tmp_path, monkeypatch, caplog,
                                           tsv_file):
    """A source that does not compile: no library, the compiler's message
    logged once, and pandas parses the file."""
    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(os.path.join(loader._NATIVE_DIR, "Makefile"), src)
    (src / "fasttsv.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(loader, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(loader, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_lib_tried", False)
    monkeypatch.setattr(loader, "_build_error", None)
    with caplog.at_level(logging.WARNING, logger="harmonypy_tpu_torch"):
        assert not native_available()
        path, X = tsv_file
        np.testing.assert_allclose(load_matrix_tsv(path), X, rtol=1e-6,
                                   atol=1e-6)
    assert "make exit" in loader._build_error
    assert "fasttsv.cpp" in loader._build_error
    warned = [r for r in caplog.records if "native TSV parser" in r.message]
    assert len(warned) == 1
    assert not os.path.exists(loader._so_path())
