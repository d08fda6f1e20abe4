"""The port's ``data/kaldi_helpers`` (a copy of the JAX package's over the
port's ``data/kaldi_io``): tests/test_kaldi_io.py's ReadHelper/WriteHelper
case against the port, files written by either package's WriteHelper read
by the other's ReadHelper, and byte-equal files from both writers."""

import numpy as np
import pytest


@pytest.fixture
def mats():
    rng = np.random.default_rng(12)
    return {f"u{i}": rng.normal(size=(6 + i, 5)).astype(np.float32) for i in range(3)}


def _write(helpers, root, mats):
    ark, scp = str(root / "h.ark"), str(root / "h.scp")
    root.mkdir(exist_ok=True)
    with helpers.WriteHelper(f"ark,scp:{ark},{scp}") as w:
        for key, mat in mats.items():
            w(key, mat)
    return ark, scp


def _read(helpers, ark, scp):
    return dict(helpers.ReadHelper(f"ark:{ark}")), dict(helpers.ReadHelper(f"scp:{scp}"))


def test_read_write_helpers(tmp_path, mats):
    """tests/test_kaldi_io.py::test_read_write_helpers on the port."""
    from liteasr_tpu_torch.data import kaldi_helpers

    ark, scp = _write(kaldi_helpers, tmp_path, mats)
    got, got_scp = _read(kaldi_helpers, ark, scp)
    assert set(got) == set(mats)
    for k in mats:
        np.testing.assert_allclose(got[k], mats[k])
        np.testing.assert_allclose(got_scp[k], mats[k])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_one_package_reads_what_the_other_writes(tmp_path, mats, writer, reader):
    from liteasr_tpu.data import kaldi_helpers as jax_helpers
    from liteasr_tpu_torch.data import kaldi_helpers

    helpers = {"jax": jax_helpers, "port": kaldi_helpers}
    ark, scp = _write(helpers[writer], tmp_path, mats)
    for got in _read(helpers[reader], ark, scp):
        assert list(got) == list(mats)
        for k, mat in mats.items():
            assert got[k].dtype == mat.dtype and np.array_equal(got[k], mat), k


def test_writers_give_byte_equal_files(tmp_path, mats):
    from liteasr_tpu.data import kaldi_helpers as jax_helpers
    from liteasr_tpu_torch.data import kaldi_helpers

    files = [_write(h, tmp_path / name, mats)
             for name, h in (("jax", jax_helpers), ("port", kaldi_helpers))]
    (jax_ark, jax_scp), (port_ark, port_scp) = files
    with open(jax_ark, "rb") as a, open(port_ark, "rb") as b:
        assert a.read() == b.read()
    # the scp lines name each package's own ark at the same offsets
    jax_lines = open(jax_scp).read().replace(jax_ark, "ARK")
    port_lines = open(port_scp).read().replace(port_ark, "ARK")
    assert jax_lines == port_lines and jax_lines.count("ARK:") == len(mats)
    with pytest.raises(ValueError, match="must include ark"):
        kaldi_helpers.WriteHelper(f"scp:{tmp_path / 'x.scp'}")
    with pytest.raises(ValueError, match="unsupported rspecifier"):
        kaldi_helpers.ReadHelper("txt:x")
