"""liteasr_tpu_torch's C++ host library (native/, a copy of liteasr_tpu/native)
against its pure-Python paths, as tests/test_native.py holds the JAX
package's: Levenshtein one pair and batched, the Kaldi float-matrix reader
and kaldi_io.load_mat over it; the library builds into build/, and where it
cannot, every caller falls back with one WARNING."""

import logging
import subprocess

import numpy as np
import pytest

from liteasr_tpu_torch import native
from liteasr_tpu_torch.data import kaldi_io
from liteasr_tpu_torch.utils import score


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ is on this host: the library must build"
    return lib


def _cases(rng):
    cases = [("kitten", "sitting"), ("", "abc"), ("abc", ""), ("same", "same"),
             ("日本語テスト", "日本語のテスト"), ([1, 2, 3, 4], [1, 3, 4, 5])]
    for _ in range(20):
        n, m = rng.integers(0, 30, size=2)
        cases.append(("".join(chr(97 + int(c)) for c in rng.integers(0, 5, n)),
                      "".join(chr(97 + int(c)) for c in rng.integers(0, 5, m))))
    return cases


def test_library_builds_into_the_build_tree(lib):
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "build"


def test_native_levenshtein_matches_python(lib, rng):
    cases = _cases(rng)
    for a, b in cases:
        ref = score._levenshtein_py(a, b)
        assert native.levenshtein(a, b) == ref
        assert score.levenshtein(a, b) == ref
    assert native.levenshtein_batch(cases) == [score._levenshtein_py(a, b)
                                               for a, b in cases]
    assert native.levenshtein_batch([]) == []


def test_native_fm_read_matches_python(lib, tmp_path, rng):
    mats = {f"u{i}": rng.normal(size=(5 + i, 7)).astype(np.float32) for i in range(4)}
    scp = str(tmp_path / "n.scp")
    kaldi_io.save_ark(str(tmp_path / "n.ark"), mats, scp_path=scp)
    for key, rx in kaldi_io.load_scp(scp).items():
        path, _, off = rx.rpartition(":")
        out = native.load_fm(path, int(off))
        assert out is not None
        np.testing.assert_array_equal(out, mats[key])
        np.testing.assert_array_equal(kaldi_io.load_mat(rx), mats[key])
    # a double matrix is not the native reader's: None, and load_mat's
    # Python reader takes it
    kaldi_io.save_ark(str(tmp_path / "d.ark"), {"d": mats["u0"].astype(np.float64)},
                      scp_path=str(tmp_path / "d.scp"))
    rx = kaldi_io.load_scp(str(tmp_path / "d.scp"))["d"]
    path, _, off = rx.rpartition(":")
    assert native.load_fm(path, int(off)) is None
    np.testing.assert_allclose(kaldi_io.load_mat(rx), mats["u0"])


def test_without_the_library_callers_fall_back_with_one_warning(monkeypatch, tmp_path,
                                                                caplog, rng):
    def no_compiler(path):
        raise subprocess.CalledProcessError(1, "g++", stderr=b"no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(native, "_build", no_compiler)
    mats = {"u": rng.normal(size=(6, 3)).astype(np.float32)}
    scp = str(tmp_path / "f.scp")
    kaldi_io.save_ark(str(tmp_path / "f.ark"), mats, scp_path=scp)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        for a, b in _cases(rng):
            assert score.levenshtein(a, b) == score._levenshtein_py(a, b)
        assert native.levenshtein("a", "b") is None
        assert native.levenshtein_batch([("a", "b")]) is None
        np.testing.assert_array_equal(kaldi_io.load_mat(kaldi_io.load_scp(scp)["u"]),
                                      mats["u"])
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "pure Python" in warnings[0].getMessage()
