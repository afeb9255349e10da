"""The port's native host runtime (``ate_replication_causalml_torch/native``)
against the JAX package's native module and the port's Python
``RCompatRNG``, on every case of ``tests/test_native.py``: the C++
R-compatible RNG bit for bit, the C++ CSV reader equal to the JAX
package's reader and to NumPy (NaN where NA or blank), and the data
pipeline's native path equal to its NumPy path."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import native as tn
from ate_replication_causalml_torch.data import pipeline as tp
from ate_replication_causalml_torch.utils.rrandom import RCompatRNG
from ate_replication_causalml_tpu import native as jn

pytestmark = pytest.mark.skipif(
    not (tn.native_available() and jn.native_available()),
    reason=f"native build unavailable: {tn.native_status()} / {jn.native_status()}",
)


def test_library_builds_outside_the_package():
    status = tn.native_status()
    assert status.startswith("native: ") and status.endswith(
        os.path.join("build", "torch_native", "_rcompat.so"))
    assert os.path.dirname(tn._LIB_PATH) == tn.BUILD_DIR
    assert not os.path.exists(os.path.join(os.path.dirname(tn.__file__), "_rcompat.so"))


@pytest.mark.parametrize("seed", [1991, 0, 12325, 2**31 - 1])
def test_runif_bit_matches(seed):
    a = tn.NativeRCompatRNG(seed).runif(2000)
    np.testing.assert_array_equal(a, RCompatRNG(seed).runif(2000))
    np.testing.assert_array_equal(a, jn.NativeRCompatRNG(seed).runif(2000))


@pytest.mark.parametrize("kind", ["rounding", "rejection"])
def test_sample_with_replacement_matches(kind):
    a = tn.NativeRCompatRNG(1991, kind).sample_int(8937, 8937, replace=True)
    np.testing.assert_array_equal(a, RCompatRNG(1991, kind).sample_int(8937, 8937, replace=True))
    np.testing.assert_array_equal(
        a, jn.NativeRCompatRNG(1991, kind).sample_int(8937, 8937, replace=True))


@pytest.mark.parametrize("kind", ["rounding", "rejection"])
def test_sample_without_replacement_matches(kind):
    a = tn.NativeRCompatRNG(7, kind).sample_n_rows(229461, 50000)
    np.testing.assert_array_equal(a, RCompatRNG(7, kind).sample_n_rows(229461, 50000))
    np.testing.assert_array_equal(a, jn.NativeRCompatRNG(7, kind).sample_n_rows(229461, 50000))


def test_stream_interleaving_matches():
    """runif / sample calls drawing from one stream, in sequence."""
    a, b = tn.NativeRCompatRNG(42), RCompatRNG(42)
    np.testing.assert_array_equal(a.runif(7), b.runif(7))
    np.testing.assert_array_equal(a.sample_int(100, 10), b.sample_int(100, 10))
    np.testing.assert_array_equal(a.runif(630), b.runif(630))  # crosses a block
    np.testing.assert_array_equal(a.sample_int(50, 50, replace=True),
                                  b.sample_int(50, 50, replace=True))


def test_factory_backends():
    nat = tn.make_rcompat_rng(1991, backend="auto")
    py = tn.make_rcompat_rng(1991, backend="python")
    assert isinstance(nat, tn.NativeRCompatRNG) and isinstance(py, RCompatRNG)
    assert isinstance(tn.make_rcompat_rng(1991, backend="native"), tn.NativeRCompatRNG)
    np.testing.assert_array_equal(nat.runif(10), py.runif(10))
    with pytest.raises(ValueError):
        tn.make_rcompat_rng(1991, backend="gpu")
    with pytest.raises(ValueError):
        tn.NativeRCompatRNG(1, "other")
    with pytest.raises(ValueError):
        tn.NativeRCompatRNG(1).sample_int(5, 6)


def _both(path):
    names, out = tn.read_csv_native(str(path))
    jnames, jout = jn.read_csv_native(str(path))
    assert names == jnames
    np.testing.assert_array_equal(out, jout)  # NaN-aware, bit for bit
    return names, out


def test_csv_reader_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    mat = rng.normal(size=(50, 4)).round(6)
    lines = ["a,b,c,d"]
    for i, row in enumerate(mat):
        cells = [f"{v:.6f}" for v in row]
        if i == 3:
            cells[1] = "NA"
        if i == 7:
            cells[2] = ""
        lines.append(",".join(cells))
    path = tmp_path / "t.csv"
    path.write_text("\n".join(lines) + "\n")
    names, out = _both(path)
    assert names == ["a", "b", "c", "d"] and out.shape == (50, 4)
    expect = mat.copy()
    expect[3, 1] = np.nan
    expect[7, 2] = np.nan
    np.testing.assert_allclose(out, expect, rtol=0, atol=1e-9)
    ref = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64,
                        missing_values=("NA", "", "NaN"), filling_values=np.nan)
    np.testing.assert_array_equal(out, ref)


def test_csv_reader_no_trailing_newline(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("x,y\n1,2\n3,4")
    names, out = _both(path)
    assert names == ["x", "y"]
    np.testing.assert_array_equal(out, [[1.0, 2.0], [3.0, 4.0]])


def test_csv_reader_skips_blank_lines(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,2\n\n3,4\n\r\n5,6\n")
    _, out = _both(path)
    np.testing.assert_array_equal(out, [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])


def test_csv_reader_short_rows_are_nan(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b,c\n1,2,3\n4,5\n7,8,9\n")
    _, out = _both(path)
    assert out.shape == (3, 3)
    np.testing.assert_array_equal(out[0], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(out[1, :2], [4.0, 5.0])
    assert np.isnan(out[1, 2])
    np.testing.assert_array_equal(out[2], [7.0, 8.0, 9.0])


def test_csv_reader_all_missing_line(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n,\nNA,7\n")
    _, out = _both(path)
    assert out.shape == (2, 2)
    assert np.isnan(out[0]).all()
    assert np.isnan(out[1, 0]) and out[1, 1] == 7.0


def test_csv_reader_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        tn.read_csv_native(str(tmp_path / "none.csv"))


def test_sanitizer_clean(tmp_path):
    """The port's copy of the runtime and its selftest under ASan/UBSan."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain for the sanitizer build")
    here = os.path.dirname(tn.__file__)
    exe = str(tmp_path / "selftest")
    subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", os.path.join(here, "rcompat.cpp"),
         os.path.join(here, "rcompat_selftest.cpp"), "-o", exe],
        check=True, capture_output=True, text=True,
    )
    out = subprocess.run([exe], check=True, capture_output=True, text=True,
                         env={**os.environ, "ASAN_OPTIONS": "detect_leaks=1"})
    assert "all checks passed" in out.stdout


@pytest.fixture(scope="module")
def ggl_csv(tmp_path_factory):
    """A GGL-schema CSV of a small synthetic pool with NA and blank cells
    planted, and a spaced, quoted extra column (the header's handling)."""
    from ate_replication_causalml_torch.data.schema import GGL_SCHEMA
    from ate_replication_causalml_torch.data.synthetic import make_ggl_like

    raw = make_ggl_like(3000, seed=4)
    cols = list(GGL_SCHEMA.all_columns)
    mat = np.stack([np.asarray(raw[c], np.float64) for c in cols], axis=1)
    rng = np.random.default_rng(1)
    cells = [[repr(float(v)) for v in row] for row in mat]
    for r, c in zip(rng.integers(0, len(cells), 40), rng.integers(0, len(cols), 40)):
        cells[r][c] = "NA" if r % 2 else ""
    path = tmp_path_factory.mktemp("ggl") / "ggl.csv"
    path.write_text(",".join(cols + [' "extra" ']) + "\n"
                    + "\n".join(",".join(row + ["1"]) for row in cells) + "\n")
    return str(path), raw


def test_load_raw_csv_native_equals_numpy(ggl_csv, monkeypatch):
    """``load_raw_csv``: the native reader's columns equal the NumPy
    reader's, NaN-aware and bit for bit. The header as the JAX package
    reads it: the C++ reader drops every quote, the pipeline strips the
    spaces."""
    path, _ = ggl_csv
    nat = tp.load_raw_csv(path)
    header, _ = tn.read_csv_native(path)
    assert header[-1] == " extra " and header == jn.read_csv_native(path)[0]
    monkeypatch.setattr(tn, "native_available", lambda: False)
    py = tp.load_raw_csv(path)
    assert sorted(nat) == sorted(py)
    for c in nat:
        np.testing.assert_array_equal(nat[c], py[c])


def test_prepare_dataset_native_equals_python(ggl_csv):
    """The default (native) R stream and the Python one give the same
    frame, bit for bit, before and after the bias injection."""
    path, _ = ggl_csv
    raw = tp.load_raw_csv(path)
    cfg = tp.PrepConfig(n_obs=1500, seed=1991)
    for kind in ("rounding", "rejection"):
        c = tp.PrepConfig(n_obs=1500, seed=1991, sample_kind=kind)
        nat = tp.prepare_dataset(raw, c, device="cpu")
        py = tp.prepare_dataset(raw, c, rng=RCompatRNG(1991, sample_kind=kind), device="cpu")
        for a, b in ((nat.x, py.x), (nat.w, py.w), (nat.y, py.y)):
            assert torch.equal(a, b)
    biased, drop = tp.inject_bias(tp.prepare_dataset(raw, cfg, device="cpu"), cfg)
    ref, ref_drop = tp.inject_bias(
        tp.prepare_dataset(raw, cfg, rng=RCompatRNG(1991), device="cpu"), cfg)
    assert np.array_equal(drop, ref_drop) and torch.equal(biased.x, ref.x)
