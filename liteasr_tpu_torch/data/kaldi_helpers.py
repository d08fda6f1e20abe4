"""High-level Kaldi IO helpers (ReadHelper/WriteHelper): a copy of
liteasr_tpu/data/kaldi_helpers.py over the port's ``data/kaldi_io``.

Reference: liteasr/utils/kaldiio/highlevel.py — `ReadHelper('ark:file')` /
`ReadHelper('scp:file')` iteration and `WriteHelper('ark,scp:a.ark,a.scp')`
writing. Covers the rspecifier/wspecifier forms the reference framework
actually uses.
"""

from typing import Iterator, Tuple

import numpy as np

from liteasr_tpu_torch.data import kaldi_io


class ReadHelper:
    """with ReadHelper('ark:feats.ark') as r: for key, mat in r: ..."""

    def __init__(self, rspecifier: str):
        if ":" not in rspecifier:
            raise ValueError(f"invalid rspecifier {rspecifier!r}")
        mode, _, path = rspecifier.partition(":")
        if mode not in ("ark", "scp"):
            raise ValueError(f"unsupported rspecifier type {mode!r}")
        self.mode = mode
        self.path = path

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        if self.mode == "ark":
            yield from kaldi_io.load_ark(self.path)
        else:
            for key, rx in kaldi_io.load_scp(self.path).items():
                yield key, kaldi_io.load_mat(rx)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class WriteHelper:
    """with WriteHelper('ark,scp:a.ark,a.scp') as w: w(key, mat)"""

    def __init__(self, wspecifier: str):
        mode, _, paths = wspecifier.partition(":")
        modes = mode.split(",")
        path_list = paths.split(",")
        if len(modes) != len(path_list):
            raise ValueError(f"invalid wspecifier {wspecifier!r}")
        spec = dict(zip(modes, path_list))
        if "ark" not in spec:
            raise ValueError("wspecifier must include ark:")
        self.ark_path = spec["ark"]
        self.scp_path = spec.get("scp")
        self._ark = open(self.ark_path, "wb")
        self._scp = open(self.scp_path, "w") if self.scp_path else None

    def __call__(self, key: str, mat: np.ndarray) -> None:
        import os

        self._ark.write(key.encode() + b" ")
        offset = kaldi_io.write_mat(self._ark, np.asarray(mat))
        if self._scp:
            self._scp.write(
                f"{key} {os.path.abspath(self.ark_path)}:{offset}\n")

    def close(self):
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
