"""PyTorch port, the native CSV reader and writer (``native/``) against the
JAX package's: the 15 cases of ``tests/test_native.py``, each run through
both packages on the same files, with equal arrays read and byte-equal
files written; the records layer's preference for it and its numpy
fallback."""

import logging

import numpy as np
import pytest

from gan_deeplearning4j_tpu.data import records as jax_records
from gan_deeplearning4j_tpu.native import csv_loader as jax_csv
from gan_deeplearning4j_tpu_torch.data import records
from gan_deeplearning4j_tpu_torch.native import build, csv_loader


@pytest.fixture(autouse=True)
def _native_libraries():
    """Both packages' libraries, built at first use (never at import)."""
    if not (csv_loader.available() and jax_csv.available()):
        pytest.skip("no g++ to build the native libraries")


def _both_read(path, **kw):
    """The port's parse, after checking it equals the JAX package's."""
    mine = csv_loader.load_csv(str(path), **kw)
    np.testing.assert_array_equal(mine, jax_csv.load_csv(str(path), **kw))
    assert mine.dtype == np.float32
    return mine


def _both_write(tmp_path, array, **kw) -> str:
    """The port's written text, after checking it is byte-equal to the JAX
    package's."""
    mine, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
    csv_loader.write_csv(str(mine), array, **kw)
    jax_csv.write_csv(str(theirs), array, **kw)
    assert mine.read_bytes() == theirs.read_bytes()
    return mine.read_text()


class TestNativeRead:
    def test_parity_with_numpy(self, tmp_path):
        rng = np.random.default_rng(0)
        arr = (rng.random((50, 17)) * 200 - 100).astype(np.float32)
        p = tmp_path / "a.csv"
        np.savetxt(p, arr, delimiter=",", fmt="%.6f")
        ref = np.loadtxt(p, delimiter=",", dtype=np.float32, ndmin=2)
        np.testing.assert_array_equal(_both_read(p), ref)

    def test_exponent_nan_inf_and_integers(self, tmp_path):
        p = tmp_path / "b.csv"
        p.write_text("1e-3,2.5E2,-4,nan,inf,-inf,0,666\n")
        out = _both_read(p)
        assert out.shape == (1, 8)
        np.testing.assert_allclose(out[0, :3], [1e-3, 250.0, -4.0])
        assert np.isnan(out[0, 3])
        assert np.isposinf(out[0, 4]) and np.isneginf(out[0, 5])
        assert out[0, 6] == 0.0 and out[0, 7] == 666.0

    def test_skip_lines_crlf_and_trailing_newline(self, tmp_path):
        p = tmp_path / "c.csv"
        p.write_text("header,line\r\n1.5,2.5\r\n3.5,4.5\n\n")
        np.testing.assert_array_equal(_both_read(p, skip_lines=1), [[1.5, 2.5], [3.5, 4.5]])

    @pytest.mark.parametrize("text,message", [
        ("1,2,3\n4,5\n", "ragged"),
        ("1,2\n3,abc\n", "parse"),
        ("", "empty"),
    ])
    def test_malformed_input_is_rejected(self, tmp_path, text, message):
        p = tmp_path / "d.csv"
        p.write_text(text)
        for loader in (csv_loader, jax_csv):
            with pytest.raises(ValueError, match=message):
                loader.load_csv(str(p))

    def test_missing_file(self, tmp_path):
        for loader in (csv_loader, jax_csv):
            with pytest.raises(ValueError, match="open"):
                loader.load_csv(str(tmp_path / "nope.csv"))


class TestNativeWrite:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_roundtrip_and_format_parity(self, tmp_path, dtype):
        rng = np.random.default_rng(1)
        arr = (rng.random((40, 7)) * 2000 - 1000).astype(dtype)
        _both_write(tmp_path, arr, precision=4)
        p_np = tmp_path / "p.csv"
        np.savetxt(p_np, arr, delimiter=",", fmt="%.4f")
        a = np.loadtxt(tmp_path / "port.csv", delimiter=",", ndmin=2)
        b = np.loadtxt(p_np, delimiter=",", ndmin=2)
        # same values to within the last printed digit (float32 input may
        # break a half-ulp tie otherwise than printf)
        np.testing.assert_allclose(a, b, atol=1.01e-4)
        if dtype == np.float64:
            assert (tmp_path / "port.csv").read_bytes() == p_np.read_bytes()

    def test_special_values(self, tmp_path):
        arr = np.array([[np.nan, np.inf, -np.inf, 1e20, -0.0]], np.float32)
        txt = _both_write(tmp_path, arr, precision=2)
        assert "nan" in txt and "inf" in txt
        back = _both_read(tmp_path / "port.csv")
        assert np.isnan(back[0, 0]) and np.isposinf(back[0, 1])

    def test_bad_shape_rejected(self, tmp_path):
        for loader in (csv_loader, jax_csv):
            with pytest.raises(ValueError, match="2-D"):
                loader.write_csv(str(tmp_path / "x.csv"), np.zeros(3))

    def test_large_values_not_corrupted(self, tmp_path):
        # v * 10^precision overflowing uint64 must take the printf path, not
        # emit zeros
        arr = np.array([[1e14, 2e13, 3.4e38, -1.5e16]], np.float32)
        txt = _both_write(tmp_path, arr, precision=6)
        np.testing.assert_allclose(_both_read(tmp_path / "port.csv"), arr, rtol=1e-6)
        assert "\x00" not in txt

    def test_max_float_high_precision_no_nul_bytes(self, tmp_path):
        arr = np.full((300, 4), np.finfo(np.float32).max, np.float32)
        txt = _both_write(tmp_path, arr, precision=17)
        assert "\x00" not in txt
        np.testing.assert_allclose(_both_read(tmp_path / "port.csv"), arr, rtol=1e-6)


class TestIntegration:
    def test_record_reader_uses_native(self, tmp_path, monkeypatch):
        arr = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
        p, q = tmp_path / "r.csv", tmp_path / "j.csv"
        records.write_csv(str(p), arr, precision=6)
        jax_records.write_csv(str(q), arr, precision=6)
        assert p.read_bytes() == q.read_bytes()
        calls = []
        monkeypatch.setattr(csv_loader, "load_csv", lambda *a, **k: calls.append(a) or jax_csv.load_csv(*a, **k))
        reader = records.CSVRecordReader(0, ",")
        reader.initialize(records.FileSplit(str(p)))
        ref = jax_records.CSVRecordReader(0, ",")
        ref.initialize(jax_records.FileSplit(str(q)))
        assert calls
        np.testing.assert_array_equal(reader.data, ref.data)
        np.testing.assert_allclose(reader.data, arr, atol=1e-6)

    def test_fallback_uses_numpy_and_logs_once(self, tmp_path, monkeypatch, caplog):
        monkeypatch.setattr(csv_loader, "available", lambda: False)
        monkeypatch.setattr(records, "_fallback_logged", False)
        arr = np.ones((2, 2), np.float32) / 3.0
        p = tmp_path / "f.csv"
        with caplog.at_level(logging.WARNING, logger=records.__name__):
            records.write_csv(str(p), arr, precision=3)
            reader = records.CSVRecordReader(0, ",")
            reader.initialize(records.FileSplit(str(p)))
        np.testing.assert_allclose(np.loadtxt(p, delimiter=",", ndmin=2), np.full((2, 2), 0.333), atol=1e-9)
        np.testing.assert_array_equal(reader.data, np.full((2, 2), 0.333, np.float32))
        messages = [r.getMessage() for r in caplog.records]  # a write and a read: logged once
        assert len(messages) == 1 and "numpy" in messages[0]

    def test_rebuild_is_cached(self):
        path = build.build()
        assert path is not None and path == build.library_path()
        assert not build.needs_build()
        assert build.build() == path
