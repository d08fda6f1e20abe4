"""Kaldi-style manifest readers.

Capability parity with the reference sheets (liteasr/dataclass/sheet.py:
19-123). ``AudioSheet`` yields ``(uttid, rxspec, start, num_frames)`` from
one of three manifest layouts, preferred in this order:

1. ``feats.scp`` + ``utt2num_frames`` — precomputed features (start=None),
2. ``wav.scp`` + ``segments`` — time-stamped slices of 16 kHz recordings,
3. bare ``wav.scp`` — whole recordings, lengths probed by decoding each wav.

``TextSheet`` yields ``(uttid, tokenids, text)``. With ``delimiter=None``
the transcript is char-level: only the first whitespace-separated field is
tokenized, character by character (so char-level corpora must store the
label sequence as one unbroken string).
"""

import os
from typing import Iterator, Optional, Tuple

from liteasr_tpu_torch.data import kaldi_io
from liteasr_tpu_torch.data.vocab import Vocab

SAMPLE_RATE = 16000


def _line_count(path: Optional[str]) -> int:
    if path is None:
        return 0
    with open(path, "r") as f:
        return sum(1 for _ in f)


def _two_fields(line: str, path: str) -> Tuple[str, str]:
    fields = line.strip().split(None, 1)
    if len(fields) != 2:
        raise ValueError(
            f"{path}: malformed manifest line (want 'key value'): "
            f"{line.strip()!r}")
    return fields[0], fields[1]


class AudioSheet:
    """Iterate utterance locations from a Kaldi data directory."""

    def __init__(self, data_dir: str):
        have = set(os.listdir(data_dir))
        self.data_dir = data_dir
        if "feats.scp" in have:
            if "utt2num_frames" not in have:
                raise FileNotFoundError(
                    f"{data_dir}: feats.scp needs utt2num_frames beside it")
            self.mode = "feats"
            self._count = _line_count(os.path.join(data_dir, "feats.scp"))
        elif "wav.scp" in have:
            self.mode = "segments" if "segments" in have else "wav"
            self._count = max(
                _line_count(os.path.join(data_dir, "wav.scp")),
                _line_count(os.path.join(data_dir, "segments"))
                if self.mode == "segments" else 0)
        else:
            raise FileNotFoundError(
                f"{data_dir}: no feats.scp or wav.scp manifest")

    def _path(self, name: str) -> str:
        return os.path.join(self.data_dir, name)

    def _iter_feats(self) -> Iterator:
        scp, shp = self._path("feats.scp"), self._path("utt2num_frames")
        with open(scp) as fscp, open(shp) as fshp:
            for scp_line, shp_line in zip(fscp, fshp):
                uttid, rxspec = _two_fields(scp_line, scp)
                uttid_shp, frames = _two_fields(shp_line, shp)
                if uttid != uttid_shp:
                    raise ValueError(
                        f"{scp} and {shp} disagree on order: "
                        f"{uttid!r} vs {uttid_shp!r}")
                yield uttid, rxspec, None, int(frames)

    def _iter_segments(self) -> Iterator:
        recordings = {}
        wav_scp = self._path("wav.scp")
        with open(wav_scp) as f:
            for line in f:
                wavid, rxspec = _two_fields(line, wav_scp)
                recordings[wavid] = rxspec
        seg_path = self._path("segments")
        with open(seg_path) as f:
            for line in f:
                fields = line.strip().split()
                if len(fields) != 4:
                    raise ValueError(
                        f"{seg_path}: malformed segment (want "
                        f"'uttid wavid start end'): {line.strip()!r}")
                uttid, wavid, start_s, end_s = fields
                start = round(float(start_s) * SAMPLE_RATE)
                end = round(float(end_s) * SAMPLE_RATE)
                yield uttid, recordings[wavid], start, end - start - 1

    def _iter_wav(self) -> Iterator:
        wav_scp = self._path("wav.scp")
        with open(wav_scp) as f:
            for line in f:
                uttid, rxspec = _two_fields(line, wav_scp)
                samples, _ = kaldi_io.read_wav(rxspec)
                yield uttid, rxspec, 0, len(samples)

    def __iter__(self):
        return {"feats": self._iter_feats,
                "segments": self._iter_segments,
                "wav": self._iter_wav}[self.mode]()

    def __len__(self):
        return self._count


class TextSheet:
    """Iterate tokenized transcripts from ``<data_dir>/text``."""

    def __init__(self, data_dir: str, vocab: Vocab,
                 delimiter: Optional[str] = None):
        self.path = os.path.join(data_dir, "text")
        self.vocab = vocab
        self.delimiter = delimiter
        self._count = _line_count(self.path)

    def __iter__(self):
        with open(self.path) as f:
            for line in f:
                uttid, text = _two_fields(line, self.path)
                if self.delimiter is None:
                    # char-level: tokenize the first field's characters
                    tokenids = self.vocab.lookup(text.split(None)[0])
                else:
                    tokenids = self.vocab.lookup(text.split(self.delimiter))
                yield uttid, tokenids, text

    def __len__(self):
        return self._count
