"""ctypes bindings to the C++ host loops in ``liteasr_native.cc`` (a copy of
liteasr_tpu/native): Levenshtein distance over code points, one pair or a
batch, and the Kaldi binary float-matrix reader.

The library is built with g++ at first use into ``build/liteasr_tpu_torch/``
(named by a hash of the source and flags; ``utils/shared_lib.py``), never
beside the source. Where it cannot be built or loaded, every caller falls
back to its pure-Python version, and the first such fallback logs a WARNING.
"""

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from liteasr_tpu_torch.utils import shared_lib
from liteasr_tpu_torch.utils.shared_lib import BUILD_DIR  # noqa: F401 (native.BUILD_DIR)

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "liteasr_native.cc"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    return shared_lib.library_path("liteasr_native", [SOURCE.read_bytes()], CXX_FLAGS)


def _build(path: Path) -> None:
    shared_lib.build({path: ["g++", *CXX_FLAGS, str(SOURCE)]}, timeout=300)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.levenshtein_u32.restype = ctypes.c_int
    lib.levenshtein_u32.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int]
    lib.levenshtein_batch_u32.restype = None
    lib.levenshtein_batch_u32.argtypes = [u32p, i64p, u32p, i64p, ctypes.c_int, i32p]
    lib.kaldi_fm_shape.restype = ctypes.c_int
    lib.kaldi_fm_shape.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p]
    lib.kaldi_fm_read.restype = ctypes.c_int
    lib.kaldi_fm_read.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (after one WARNING)
    where g++ or the loader fails."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    try:
        if not path.is_file():
            _build(path)
        _lib = _bind(ctypes.CDLL(str(path)))
    except (OSError, subprocess.SubprocessError, shared_lib.BuildError) as e:
        detail = getattr(e, "stderr", None) or e
        logger.warning("the native host library could not be built or loaded "
                       "(%s); scoring and feature reads fall back to pure Python",
                       detail)
    return _lib


def _as_u32(seq) -> np.ndarray:
    if isinstance(seq, str):
        return np.frombuffer(seq.encode("utf-32-le"), dtype=np.uint32).copy()
    return np.asarray(list(seq), dtype=np.uint32)


def _u32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def levenshtein(a, b) -> Optional[int]:
    """Edit distance of two strings (by code point) or integer sequences;
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    ua, ub = _as_u32(a), _as_u32(b)
    return int(lib.levenshtein_u32(_u32_ptr(ua), len(ua), _u32_ptr(ub), len(ub)))


def levenshtein_batch(pairs: Sequence[Tuple[object, object]]) -> Optional[List[int]]:
    """Edit distances of (ref, hyp) pairs in one call; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    refs, hyps = [_as_u32(r) for r, _ in pairs], [_as_u32(h) for _, h in pairs]

    def flat(seqs):
        off = np.zeros(len(seqs) + 1, np.int64)
        off[1:] = np.cumsum([len(s) for s in seqs])
        cat = np.concatenate(seqs) if seqs else np.zeros(0, np.uint32)
        return np.ascontiguousarray(cat, dtype=np.uint32), off

    (r, r_off), (h, h_off) = flat(refs), flat(hyps)
    out = np.zeros(len(pairs), np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.levenshtein_batch_u32(_u32_ptr(r), r_off.ctypes.data_as(i64p), _u32_ptr(h),
                              h_off.ctypes.data_as(i64p), len(pairs),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out.tolist()


def load_fm(path: str, offset: int) -> Optional[np.ndarray]:
    """The Kaldi binary float matrix ("\\0B" "FM ") at ``offset`` of ``path``;
    None without the library or for anything else (the caller's Python
    reader handles DM, CM and vectors)."""
    lib = get_lib()
    if lib is None:
        return None
    rows, cols = ctypes.c_int32(), ctypes.c_int32()
    if lib.kaldi_fm_shape(path.encode(), offset, ctypes.byref(rows), ctypes.byref(cols)):
        return None
    out = np.empty((rows.value, cols.value), dtype=np.float32)
    rc = lib.kaldi_fm_read(path.encode(), offset,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    return None if rc else out
