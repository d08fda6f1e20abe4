"""Fused attention forward with the in-kernel rel-pos term: the CUDA port
of the Pallas kernel ``liteasr_tpu/ops/flash_attention.py:_attn_kernel``
(wrapper ``flash_attention``, helpers ``_bd_full`` and ``_row_roll_left``).

It computes, for each folded (batch x head) row ``bh``,

    S = (Q K^T + relshift(Q_v P^T)) * scale
    S[mask] = S[key >= kv_len] = NEG_INF
    out = softmax(S) V

where ``relshift`` is the legacy Transformer-XL alignment of
``liteasr_tpu/nets/attention.py:191-202`` read from the compact (Tk, D)
position table: for key j <= t it reads R[t, Tk-1-t+j], at j == t+1 it
gives 0, and for j > t+1 it reads R[t+1, j-t-2] (the next query's row).

On the card, ``csrc/rel_attention_fwd.cu`` does this in one pass per
64-row query tile: the (Tq, Tk) score matrix never reaches device memory,
which is what the TPU kernel was written for. What bounds it on the H100:
a block reads each K, V and position-table row once per 64 queries, so
device-memory traffic is small and the dot products bound it. This first
version computes them with fp32 FMAs from shared memory, not on the tensor
cores, so it is bound by shared-memory loads and FMA issue; the rel-pos
term reuses the same register blocking (a thread's 4x4 scores share 7
diagonals of the position window). ``wgmma``/TMA tiles are the next step.

The plain PyTorch version (``flash_attention_plain``) computes the same
function with einsums and ``rel_shift``. The wrapper takes it only for CPU
tensors; a CUDA tensor launches the kernel or raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 128

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "rel_attention_fwd.cu"
# build output lives beside the package, in the repository's build/ tree
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "liteasr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift on (..., T1, T2): pad a zero column,
    reshape to (T2+1, T1), drop the first row, reshape back
    (liteasr_tpu/nets/attention.py:191-202)."""
    *lead, t1, t2 = x.shape
    x_padded = torch.cat([x.new_zeros(*lead, t1, 1), x], dim=-1)
    x_padded = x_padded.reshape(*lead, t2 + 1, t1)
    return x_padded[..., 1:, :].reshape(*lead, t1, t2)


def _group_rows(bh: int, n: int, what: str) -> int:
    if n <= 0 or bh % n:
        raise ValueError(f"{what} has {n} rows, which do not divide BH={bh}")
    return bh // n


def flash_attention_plain(q, k, v, mask=None, kv_lens=None, rel_qv=None,
                          rel_p=None, scale: float = 1.0):
    """Plain PyTorch version of the kernel: fp32 scores and softmax.

    Same arguments as :func:`flash_attention`; follows
    ``_ref_rel_attention`` (liteasr_tpu/ops/flash_attention.py:450-466)
    plus the mask input.
    """
    bh = q.shape[0]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    if rel_qv is not None:
        p = rel_p.float()
        p = p.repeat(_group_rows(bh, p.shape[0], "rel_p"), 1, 1)
        s = s + rel_shift(torch.einsum("bqd,bkd->bqk", rel_qv.float(), p))
    s = s * scale
    if mask is not None:
        m = mask.repeat_interleave(_group_rows(bh, mask.shape[0], "mask"), 0)
        s = s.masked_fill(m, NEG_INF)
    if kv_lens is not None:
        j = torch.arange(s.shape[-1], device=s.device)
        s = s.masked_fill(j[None, None, :] >= kv_lens[:, None, None], NEG_INF)
    attn = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", attn, v.float()).to(q.dtype)


def flash_attention(q, k, v, mask=None, kv_lens=None, rel_qv=None,
                    rel_p=None, scale: float = 1.0):
    """Fused attention forward.

    :param q: (BH, Tq, D); ``k``/``v``: (BH, Tk, D); float32 or bfloat16
    :param mask: optional (M, Tq, Tk) bool, True = masked; row ``bh`` reads
        ``mask[bh // (BH // M)]`` (M = B shares one mask across the heads
        of a batch row)
    :param kv_lens: optional (BH,) int32; keys at position >= kv_len are
        masked (suffix padding)
    :param rel_qv: optional (BH, Tq, D) position-query rows (q + pos_bias_v)
    :param rel_p: (P, Tk, D) compact position table; row ``bh`` reads
        ``rel_p[bh % P]`` (P = H shares it across the batch). Needs
        Tq == Tk.
    :return: (BH, Tq, D) in q's dtype

    A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor launches
    the kernel (``flash_attention.launches`` counts those launches).
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, kv_lens, rel_qv, rel_p,
                                     scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = _launch(q, k, v, mask, kv_lens, rel_qv, rel_p, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous")


def _launch(q, k, v, mask, kv_lens, rel_qv, rel_p, scale):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"flash_attention: q must be (BH, Tq, D), got {tuple(q.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} not in 1..{MAX_HEAD_DIM}")
    dev = q.device
    _check("q", q, q.dtype, (bh, tq, d), dev)
    _check("k", k, q.dtype, (bh, tk, d), dev)
    _check("v", v, q.dtype, (bh, tk, d), dev)
    mask_div, p_mod = 1, 1
    if mask is not None:
        mask_div = _group_rows(bh, mask.shape[0], "mask")
        _check("mask", mask, torch.bool, (bh // mask_div, tq, tk), dev)
        mask = mask.view(torch.uint8)
    if kv_lens is not None:
        _check("kv_lens", kv_lens, torch.int32, (bh,), dev)
    if (rel_qv is None) != (rel_p is None):
        raise ValueError("flash_attention: rel_qv and rel_p go together")
    if rel_qv is not None:
        if tq != tk:
            raise ValueError("flash_attention: the rel-pos term needs Tq == Tk")
        p_mod = rel_p.shape[0]
        _group_rows(bh, p_mod, "rel_p")
        _check("rel_qv", rel_qv, q.dtype, (bh, tq, d), dev)
        _check("rel_p", rel_p, q.dtype, (p_mod, tk, d), dev)
    out = torch.empty_like(q)
    if bh == 0 or tq == 0:
        return out

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_library().rel_attention_fwd(
            _DTYPE_CODE[q.dtype], ptr(q), ptr(k), ptr(v), ptr(rel_qv),
            ptr(rel_p), ptr(mask), ptr(kv_lens), ptr(out), bh, tq, tk, d,
            mask_div, p_mod, ctypes.c_float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"rel_attention_fwd launch failed: CUDA error {err}")
    return out


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        f"kernel {_SRC.name} cannot be built")


def library_path() -> Path:
    """Where the kernel library for the current source lives."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librel_attention_fwd.{digest}.so"


def build_library() -> Path:
    """Compile ``csrc/rel_attention_fwd.cu`` for sm_90a if it is not built."""
    path = library_path()
    if path.is_file():
        return path
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRC)], check=True)
        os.replace(tmp, path)  # atomic: concurrent builders never see a half file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library. Raises when there is no
    CUDA device or no nvcc; there is no fallback."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the rel_attention_fwd kernel needs an "
            "NVIDIA GPU (sm_90a) and nvcc")
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.rel_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _LIB = lib
    return lib
