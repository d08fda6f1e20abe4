"""Pure-numpy Kaldi ark/scp/wav reader-writer.

Covers the subset of the reference's vendored kaldiio that the framework
actually exercises (liteasr/utils/kaldiio/matio.py: `load_mat` :225,
`_parse_arkpath` :244 incl. pipe commands, binary float/double matrices,
compressed matrices :460-556, `save_ark` :643; utils.py `open_like_kaldi`
:162 for `command |` pipes), plus 16-bit PCM wav reading used by
dataclass/audio_data.py:31.

Formats:
* scp line:  ``<uttid> <path>[:<byte-offset>][<row-range>[,<col-range>]]``
  where ranges use Kaldi's inclusive ends (``a.ark:12[3:4]`` = rows 3..4)
* binary ark entry: ``<uttid> \\0B<token>...`` where token is ``FM`` (float32
  matrix), ``DM`` (float64), ``FV``/``DV`` (vectors), or ``CM``/``CM2``/
  ``CM3`` (Kaldi compressed matrix formats 1-3)
* text ark entry: ``<uttid>  [\\n r0c0 r0c1 ...\\n ... ]``
* wav: PCM 8/16/24/32-bit and IEEE float 32/64-bit (the stdlib ``wave``
  module handles neither 24-bit nor float)
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
import wave
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from liteasr_tpu_torch import native


# ---------------------------------------------------------------- low level

def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if c in (b" ", b""):
            break
        tok += c
    return tok.decode()


def _expect_basic_int(f) -> int:
    size = f.read(1)
    assert size == b"\x04", f"unexpected int size byte {size!r}"
    return struct.unpack("<i", f.read(4))[0]


def _write_basic_int(f, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def open_like_kaldi(rxspec: str, mode: str = "rb"):
    """Open a path or a trailing-'|' pipe command like Kaldi rxfilenames."""
    rxspec = rxspec.strip()
    if rxspec.endswith("|"):
        proc = subprocess.Popen(rxspec[:-1], shell=True, stdout=subprocess.PIPE)
        return io.BytesIO(proc.stdout.read())
    return open(rxspec, mode)


# ---------------------------------------------------- rxspecifier parsing

def parse_rxspec(rxspec: str):
    """``path[:offset][<range>]`` -> (path, offset, slices).

    Range specifiers use Kaldi's inclusive ends
    (liteasr/utils/kaldiio/matio.py:244-320 semantics):

    >>> parse_rxspec('a.ark:12')
    ('a.ark', 12, None)
    >>> parse_rxspec('a.ark:12[3:4]')
    ('a.ark', 12, (slice(3, 5, None),))
    >>> parse_rxspec('a.ark[0:9,2:5]')
    ('a.ark', None, (slice(0, 10, None), slice(2, 6, None)))
    """
    rxspec = rxspec.strip()
    if rxspec.endswith("|") or rxspec.startswith("|"):
        return rxspec, None, None  # pipe commands are never range-parsed

    slices = None
    if "[" in rxspec and rxspec.endswith("]"):
        base, _, rng = rxspec[:-1].partition("[")
        parsed = []
        ok = True
        for dim in rng.split(","):
            dim = dim.strip()
            if dim in ("", ":"):
                parsed.append(slice(None))
                continue
            lo, sep, hi = dim.partition(":")
            try:
                lo_i = int(lo) if lo else None
                hi_i = int(hi) + 1 if hi else None  # Kaldi ends inclusive
            except ValueError:
                ok = False
                break
            parsed.append(slice(lo_i, hi_i) if sep else
                          slice(int(lo), int(lo) + 1))
        if ok:
            slices = tuple(parsed)
            rxspec = base

    path, _, offset = rxspec.rpartition(":")
    if path and offset.isdigit():
        return path, int(offset), slices
    return rxspec, None, slices


# ------------------------------------------------------------- matrix read

def _uint_to_float(u, min_value, value_range, c):
    # operation order matches Kaldi's decoder exactly (min + u * range / c)
    # so decompression is bit-identical to the reference reader
    return min_value + u.astype(np.float32) * value_range / c


def _read_compressed_matrix(f, fmt: str) -> np.ndarray:
    """Kaldi CompressedMatrix formats 1-3 ('CM'/'CM2'/'CM3').

    Format 1 stores per-column percentile headers and uint8 codes in a
    piecewise-linear 0-25-75-100 percentile mapping; formats 2/3 are plain
    row-major uint16/uint8 linear quantization of the global [min, min+range]
    (liteasr/utils/kaldiio/matio.py:474-517, compression_header.py:17-251).
    """
    # GlobalHeader: min_value, range (float32), num_rows, num_cols (int32)
    min_value, value_range, num_rows, num_cols = struct.unpack(
        "<ffii", f.read(16))

    if fmt == "CM2":
        data = np.frombuffer(f.read(2 * num_rows * num_cols), dtype="<u2")
        return _uint_to_float(
            data, min_value, value_range, 65535.0).reshape(
            num_rows, num_cols)
    if fmt == "CM3":
        data = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8)
        return _uint_to_float(
            data, min_value, value_range, 255.0).reshape(num_rows, num_cols)

    # format 1: per-column headers of 4 uint16-encoded percentiles
    headers = np.frombuffer(f.read(8 * num_cols), dtype="<u2").reshape(
        num_cols, 4)
    data = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8)
    data = data.reshape(num_cols, num_rows)

    p = _uint_to_float(headers, min_value, value_range, 65535.0)
    p0, p25 = p[:, 0][:, None], p[:, 1][:, None]
    p75, p100 = p[:, 2][:, None], p[:, 3][:, None]

    d = data.astype(np.float32)
    lo = d <= 64
    hi = d > 192
    out = np.where(
        lo, p0 + (p25 - p0) * d * (1 / 64.0),
        np.where(hi, p75 + (p100 - p75) * (d - 192.0) * (1 / 63.0),
                 p25 + (p75 - p25) * (d - 64.0) * (1 / 128.0)))
    return np.ascontiguousarray(out.T)


def _read_ascii_mat(f, first: bytes) -> np.ndarray:
    """Text-mode matrix/vector: ``[\\n 1 2\\n 3 4 ]`` after the key."""
    buf = first
    while True:
        c = f.read(1)
        if not c:
            break
        buf += c
        if c == b"]":
            break
    text = buf.decode()
    if "[" not in text:
        # bare vector of numbers on one line
        return np.array([float(t) for t in text.split()], dtype=np.float32)
    body = text[text.index("[") + 1: text.rindex("]")]
    rows = [r.strip() for r in body.strip().splitlines() if r.strip()]
    mat = [[float(t) for t in r.split()] for r in rows]
    arr = np.asarray(mat, dtype=np.float32)
    return arr[0] if arr.shape[0] == 1 and "\n" not in body.strip() else arr


def read_kaldi(f) -> np.ndarray:
    """Read one object at the current position (after any key)."""
    binary = f.read(2)
    if binary != b"\x00B":
        return _read_ascii_mat(f, binary)  # text-mode entry
    token = _read_token(f)
    if token in ("FM", "DM"):
        rows = _expect_basic_int(f)
        cols = _expect_basic_int(f)
        dtype = "<f4" if token == "FM" else "<f8"
        count = rows * cols
        mat = np.frombuffer(f.read(count * np.dtype(dtype).itemsize), dtype=dtype)
        return mat.reshape(rows, cols).astype(np.float32, copy=False)
    if token in ("FV", "DV"):
        dim = _expect_basic_int(f)
        dtype = "<f4" if token == "FV" else "<f8"
        vec = np.frombuffer(f.read(dim * np.dtype(dtype).itemsize), dtype=dtype)
        return vec.astype(np.float32, copy=False)
    if token in ("CM", "CM2", "CM3"):
        return _read_compressed_matrix(f, token)
    raise ValueError(f"unsupported Kaldi token {token!r}")


def load_mat(ark_path: str) -> np.ndarray:
    """Load one matrix from an rxspecifier: ``path[:offset][range]``
    (feats.scp entry) or a bare ark path positioned at its first entry."""
    path, offset, slices = parse_rxspec(ark_path)
    if offset is not None:
        mat = None
        if not path.endswith("|") and slices is None:
            # a plain file: the native reader takes binary float matrices
            mat = native.load_fm(path, offset)
        if mat is None:
            with open_like_kaldi(path) as f:
                f.seek(offset)
                mat = read_kaldi(f)
    else:
        with open_like_kaldi(path) as f:
            # bare ark: skip the key of the first entry
            _read_token(f)
            mat = read_kaldi(f)
    if slices is not None:
        mat = mat[slices]
    return mat


def load_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    with open_like_kaldi(path) as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            yield key, read_kaldi(f)


def load_scp(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            key, _, rx = line.strip().partition(" ")
            out[key] = rx.strip()
    return out


# ------------------------------------------------------------ matrix write

def _float_to_uint(x, min_value, value_range, c):
    # +0.499 rounds to the closest code like the Kaldi encoder
    u = (x - min_value) / value_range * c + 0.499
    return np.clip(u, 0, c)


def _write_compressed_matrix(f, mat: np.ndarray, fmt: str) -> None:
    mat = np.asarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    min_value = float(mat.min()) if mat.size else 0.0
    value_range = float(mat.max() - min_value) if mat.size else 1.0
    if value_range == 0.0:
        value_range = 1.0
    f.write(fmt.encode() + b" ")
    f.write(struct.pack("<ffii", min_value, value_range, rows, cols))

    if fmt == "CM2":
        f.write(_float_to_uint(mat, min_value, value_range,
                               65535.0).astype("<u2").tobytes())
        return
    if fmt == "CM3":
        f.write(_float_to_uint(mat, min_value, value_range,
                               255.0).astype("u1").tobytes())
        return

    # format 1: per-column 0/25/75/100 percentiles (Kaldi's partition
    # scheme, compression_header.py:169-214), quantized to uint16, then
    # uint8 codes in the piecewise-linear percentile mapping
    quarter = rows // 4
    if rows >= 5:
        srows = np.partition(mat, [0, quarter, 3 * quarter, rows - 1], axis=0)
        p0, p25 = srows[0], srows[quarter]
        p75, p100 = srows[3 * quarter], srows[rows - 1]
    else:
        srows = np.sort(mat, axis=0)
        p0 = srows[0]
        p25 = srows[1] if rows > 1 else p0 + 1
        p75 = srows[2] if rows > 2 else p25 + 1
        p100 = srows[3] if rows > 3 else p75 + 1
    u = [_float_to_uint(p, min_value, value_range, 65535.0).astype(np.int64)
         for p in (p0, p25, p75, p100)]
    u[0] = np.minimum(u[0], 65532)
    u[1] = np.minimum(np.maximum(u[1], u[0] + 1), 65533)
    u[2] = np.minimum(np.maximum(u[2], u[1] + 1), 65534)
    u[3] = np.maximum(u[3], u[2] + 1)
    headers = np.stack(u, axis=1).astype("<u2")  # (cols, 4)
    f.write(headers.tobytes())

    p = _uint_to_float(headers, min_value, value_range, 65535.0)
    p0, p25 = p[:, 0][None, :], p[:, 1][None, :]
    p75, p100 = p[:, 2][None, :], p[:, 3][None, :]
    lo = mat < p25
    hi = mat >= p75
    c1 = np.clip((mat - p0) / (p25 - p0) * 64.0 + 0.5, 0.0, 64.0)
    c2 = np.clip((mat - p25) / (p75 - p25) * 128.0 + 64.5, 64.0, 192.0)
    c3 = np.clip((mat - p75) / (p100 - p75) * 63.0 + 192.5, 192.0, 255.0)
    codes = np.where(lo, c1, np.where(hi, c3, c2)).astype("u1")
    f.write(np.ascontiguousarray(codes.T).tobytes())  # column-major


def write_mat(f, mat: np.ndarray, compression_method: Optional[int] = None
              ) -> int:
    """Write one binary matrix; returns the data byte offset.

    compression_method follows kaldiio's constants: None/0 = uncompressed,
    1 = automatic (CM if > 8 rows else CM2), 2 = CM (speech feature),
    3/4 = CM2 (two-byte), 5/6/7 = CM3 (one-byte).
    """
    f.write(b"\x00B")
    offset = f.tell() - 2
    mat = np.asarray(mat)
    if compression_method:
        if compression_method == 1:
            fmt = "CM" if mat.shape[0] > 8 else "CM2"
        elif compression_method == 2:
            fmt = "CM"
        elif compression_method in (3, 4):
            fmt = "CM2"
        elif compression_method in (5, 6, 7):
            fmt = "CM3"
        else:
            raise ValueError(
                f"unknown compression_method {compression_method}")
        _write_compressed_matrix(f, mat, fmt)
        return offset
    token = b"DM " if mat.dtype == np.float64 else b"FM "
    f.write(token)
    mat = mat.astype("<f8" if token == b"DM " else "<f4", copy=False)
    _write_basic_int(f, mat.shape[0])
    _write_basic_int(f, mat.shape[1])
    f.write(mat.tobytes())
    return offset


def save_ark(
    ark_path: str,
    dict_mats: Dict[str, np.ndarray],
    scp_path: Optional[str] = None,
    append: bool = False,
    compression_method: Optional[int] = None,
) -> None:
    """Write matrices to a binary ark (+ optional scp with offsets).

    Mirrors kaldiio.save_ark (liteasr/utils/kaldiio/matio.py:643) including
    the compression_method knob.
    """
    mode = "ab" if append else "wb"
    scp_f = open(scp_path, "a" if append else "w") if scp_path else None
    with open(ark_path, mode) as f:
        for key, mat in dict_mats.items():
            f.write(key.encode() + b" ")
            offset = write_mat(f, mat, compression_method=compression_method)
            if scp_f:
                scp_f.write(f"{key} {os.path.abspath(ark_path)}:{offset}\n")
    if scp_f:
        scp_f.close()


# -------------------------------------------------------------------- wav

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_pcm(raw: bytes, width: int, fmt: int) -> np.ndarray:
    if fmt == _WAVE_FORMAT_IEEE_FLOAT:
        if width == 4:
            return np.frombuffer(raw, dtype="<f4").astype(np.float32)
        if width == 8:
            return np.frombuffer(raw, dtype="<f8").astype(np.float32)
        raise ValueError(f"unsupported float wav width {width}")
    if width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if width == 1:  # 8-bit PCM is unsigned
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    if width == 3:  # 24-bit: widen to int32 via a zero byte + sign shift
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        quads = np.zeros((b.shape[0], 4), dtype=np.uint8)
        quads[:, 1:] = b
        return (quads.view("<i4")[:, 0].astype(np.float32)
                / 2147483648.0)
    if width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) \
            / 2147483648.0
    raise ValueError(f"unsupported wav sample width {width}")


def read_wav(path_or_cmd: str) -> Tuple[np.ndarray, int]:
    """Read a (possibly piped) wav file -> (float samples in [-1, 1], rate).

    Parses RIFF directly: the stdlib ``wave`` module rejects IEEE-float and
    24-bit PCM files, both of which the reference's vendored python_wave.py
    accepts (liteasr/utils/kaldiio/python_wave.py).
    """
    f = open_like_kaldi(path_or_cmd)
    try:
        riff, _, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff not in (b"RIFF", b"RIFX") or wave_id != b"WAVE":
            raise ValueError(f"not a wav file: {path_or_cmd!r}")
        fmt_tag = channels = rate = width = None
        raw = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", head)
            if chunk_id == b"fmt ":
                fmt_data = f.read(chunk_size)
                fmt_tag, channels, rate, _, _, bits = struct.unpack(
                    "<HHIIHH", fmt_data[:16])
                if fmt_tag == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                    # SubFormat GUID's first two bytes are the real tag
                    fmt_tag = struct.unpack("<H", fmt_data[24:26])[0]
                width = bits // 8
            elif chunk_id == b"data":
                raw = f.read(chunk_size)
            else:
                f.seek(chunk_size + (chunk_size & 1), os.SEEK_CUR)
            if raw is not None and fmt_tag is not None:
                break
    finally:
        f.close()
    if raw is None or fmt_tag is None:
        raise ValueError(f"wav file missing fmt/data chunk: {path_or_cmd!r}")
    samples = _decode_pcm(raw, width, fmt_tag)
    if channels and channels > 1:
        samples = samples[: len(samples) // channels * channels]
        samples = samples.reshape(-1, channels).mean(axis=1)
    return samples, rate


def write_wav(path: str, samples: np.ndarray, rate: int = 16000) -> None:
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
