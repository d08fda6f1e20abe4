"""Utterance record with lazy feature loading.

Reference: liteasr/dataclass/audio_data.py:7-48 — ``.x`` reads a Kaldi
feature matrix (start is None) or a pcm slice of a wav file.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from liteasr_tpu_torch.data import kaldi_io


@dataclass
class Audio:
    __slots__ = ["fd", "start", "shape", "tokenids", "text"]

    fd: str
    start: Optional[int]
    shape: int
    tokenids: Optional[Tuple[int, ...]]
    text: Optional[str]

    @property
    def x(self) -> np.ndarray:
        if self.start is None:  # feature matrix
            return kaldi_io.load_mat(self.fd)
        samples, _ = kaldi_io.read_wav(self.fd)
        return samples[self.start:self.start + self.xlen].astype(np.float32)

    @property
    def xlen(self) -> int:
        return self.shape

    @property
    def y(self) -> Optional[np.ndarray]:
        if self.tokenids is None:
            return None
        return np.asarray(self.tokenids, dtype=np.int32)

    @property
    def ylen(self) -> int:
        return len(self.tokenids) if self.tokenids is not None else 0
