"""The random draws of a U2 train step, for the plain reference: a frozen
copy of the port's SpecAugment (draws and application) and of its
attention-dropout hash, and the benchmark's own dropout masks.

The masks of the step's plain dropouts (``torch.nn.functional.dropout``
in the port) are the benchmark's input in the checked steps: call ``i``
of step ``s`` keeps an element where a uniform draw from the generator
seeded by (seed, s, i) is at least the rate. The driver installs
:class:`Dropouts` in place of ``F.dropout`` for those steps, and the
reference applies the same masks by the same call order. Nothing here
imports the port.
"""

from typing import Dict

import torch

# ---- the benchmark's dropout masks


class Dropouts:
    """The masks of one step, call by call. ``index`` counts the calls;
    a recomputed region rewinds it to the call it started at."""

    def __init__(self, seed: int, step: int, device):
        self.seed, self.step, self.device = int(seed), int(step), device
        self.index = 0

    def keep(self, shape, rate: float) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + self.step * 65_537 + self.index * 7919
                         + 12_345) % (1 << 62))
        self.index += 1
        return torch.rand(shape, generator=gen, device=self.device) >= rate

    def __call__(self, x: torch.Tensor, rate: float, training: bool = True,
                 inplace: bool = False) -> torch.Tensor:
        if not training or rate == 0.0:
            return x
        keep = self.keep(x.shape, rate)
        return (x.float() * keep * (1.0 / (1.0 - rate))).to(x.dtype)


# ---- SpecAugment (liteasr_tpu_torch/ops/spec_augment.py, frozen copy)

K_TAPS = 12


def step_generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step) * 7919 + 17) % (1 << 62))
    return gen


def _uniform_int(u, lo, hi):
    n = hi - lo
    return lo + torch.minimum(torch.floor(u * n).long(), n - 1)


def draw(xlens, feat_dim: int, generator, time_warp=5, freq_mask=30, freq_mask_times=2,
         time_mask=40, time_mask_times=2) -> Dict[str, torch.Tensor]:
    dev = xlens.device
    xl = xlens.long()
    B = xl.shape[0]

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev, dtype=torch.float64)

    out = {}
    W = int(time_warp)
    lo = torch.full_like(xl, W)
    center = _uniform_int(rand(B), lo, torch.maximum(xl - W, lo + 1))
    warped = _uniform_int(rand(B), center - W, center + W) + 1
    out["center"] = center
    out["warped"] = torch.minimum(torch.clamp(warped, min=1), xl - 1)
    for name, param, times, size in (("freq", freq_mask, freq_mask_times, feat_dim),
                                     ("time", time_mask, time_mask_times, None)):
        p = max(int(param), 1)
        bound = torch.floor(rand(B, times) * p).long()
        width = torch.floor(rand(B, times) * p).long()
        limit = torch.clamp((xl[:, None] if size is None else size) - bound, min=1)
        out[f"{name}_start"] = torch.floor(rand(B, times) * limit).long()
        out[f"{name}_width"] = width
    return out


def _keys_cubic(t):
    at = t.abs()
    near = (1.5 * at - 2.5) * at * at + 1.0
    far = ((-0.5 * at + 2.5) * at - 4.0) * at + 2.0
    return torch.where(at < 1.0, near, torch.where(at < 2.0, far, 0.0))


def warp_bicubic(x, xlen, center, warped):
    B, T, D = x.shape
    i = torch.arange(T, device=x.device)[None, :]
    xlen, center, warped = (a.long()[:, None] for a in (xlen, center, warped))
    in_left = i < warped
    dst0 = torch.where(in_left, 0, warped)
    dst_len = torch.where(in_left, warped, xlen - warped)
    src0 = torch.where(in_left, 0, center)
    src_len = torch.where(in_left, center, xlen - center)
    scale = src_len.float() / torch.clamp(dst_len, min=1).float()
    fscale = torch.clamp(scale, 1.0, (K_TAPS - 1) / 4.0)
    c = src0.float() + ((i - dst0).float() + 0.5) * scale
    support = 2.0 * fscale
    pmin = torch.maximum(torch.floor(c - support + 0.5).long(), src0)
    pmax = torch.minimum(torch.floor(c + support + 0.5).long(), src0 + src_len)
    p = pmin[..., None] + torch.arange(K_TAPS, device=x.device)
    w = _keys_cubic((p.float() + 0.5 - c[..., None]) / fscale[..., None])
    w = torch.where(p < pmax[..., None], w, 0.0)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    rows = torch.gather(x.float(), 1, p.clamp(0, T - 1).reshape(B, T * K_TAPS, 1)
                        .expand(B, T * K_TAPS, D)).reshape(B, T, K_TAPS, D)
    out = torch.einsum("btk,btkd->btd", w, rows).to(x.dtype)
    return torch.where((i < xlen)[..., None], out, x)


def _valid_mean(x, xlen):
    valid = (torch.arange(x.shape[1], device=x.device)[None, :] < xlen[:, None])
    total = (x * valid[..., None]).sum(dim=(1, 2))
    return (total / torch.clamp(xlen * x.shape[2], min=1))[:, None, None]


def _mask(x, xlen, start, width, along_time: bool, replace_with_zero: bool):
    fill = 0.0 if replace_with_zero else _valid_mean(x, xlen)
    n = x.shape[1] if along_time else x.shape[2]
    idx = torch.arange(n, device=x.device)[None, None, :]
    hit = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    if along_time:
        hit = hit & (idx < xlen[:, None, None])
    hit = hit.any(dim=1)
    hit = hit[:, :, None] if along_time else hit[:, None, :]
    return torch.where(hit, fill, x)


def spec_augment(xs, xlens, generator, time_warp=5, freq_mask=30, freq_mask_times=2,
                 time_mask=40, time_mask_times=2, replace_with_zero=False,
                 time_warp_mode="bicubic"):
    """The port's ``spec_augment``: draw, then warp (bicubic only here)
    and mask."""
    if time_warp > 0 and time_warp_mode != "bicubic":
        raise ValueError(f"time_warp_mode {time_warp_mode!r} is not in the reference")
    draws = draw(xlens, xs.shape[2], generator, time_warp, freq_mask,
                 freq_mask_times if freq_mask > 0 else 0, time_mask,
                 time_mask_times if time_mask > 0 else 0)
    xl = xlens.long()
    if time_warp > 0:
        out = warp_bicubic(xs, xl, draws["center"], draws["warped"])
        too_short = (xl - time_warp <= time_warp)[:, None, None]
        xs = torch.where(too_short, xs, out)
    for name in ("freq", "time"):
        if draws[f"{name}_start"].shape[1]:
            xs = _mask(xs, xl, draws[f"{name}_start"], draws[f"{name}_width"],
                       name == "time", replace_with_zero)
    return xs


# ---- the attention kernels' dropout hash (liteasr_tpu_torch/ops/flash_attention.py)

HASH_TQ = HASH_TK = 128
_MASK32 = 0xFFFFFFFF


def hash_tiles(tq: int, tk: int):
    return min(HASH_TQ, -(-tq // 8) * 8), min(HASH_TK, -(-tk // 128) * 128)


def keep_threshold(rate: float) -> int:
    if rate <= 0.0:
        return _MASK32
    return min(int(round((1.0 - rate) * 4294967296.0)), _MASK32)


def _mul32(a, c: int):
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _tile_id(b, qi, kj, seed: int):
    tile = (_mul32(b, 65537) + qi) & _MASK32
    tile = (_mul32(tile, 8191) + kj) & _MASK32
    return (_mul32(tile, 131071) + (int(seed) & _MASK32)) & _MASK32


def attention_keep(bh: int, t_q: int, t_k: int, seed: int, rate: float,
                   device=None) -> torch.Tensor:
    """(BH, Tq, Tk) keep mask of a whole (unsharded) call."""
    tqe, tke = hash_tiles(t_q, t_k)
    t = torch.arange(t_q, dtype=torch.int64, device=device)[None, :, None]
    j = torch.arange(t_k, dtype=torch.int64, device=device)[None, None, :]
    b = torch.arange(bh, dtype=torch.int64, device=device)[:, None, None]
    tile = _tile_id(b, t // tqe, j // tke, seed)
    u = (_mul32(t % tqe, 0x9E3779B1) + _mul32(j % tke, 0x85EBCA77)
         + _mul32(tile, 0xC2B2AE3D)) & _MASK32
    u = u ^ (u >> 16)
    u = _mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = _mul32(u, 0x846CA68B)
    u = u ^ (u >> 16)
    return u < keep_threshold(rate)


class SeedStream:
    """The rel-pos attentions' kernel seeds: one int32 per train-mode call
    from a CPU generator seeded with the run's seed, in call order."""

    def __init__(self, seed: int):
        self.gen = torch.Generator()
        self.gen.manual_seed(int(seed))

    def next(self, rate: float) -> int:
        if rate <= 0.0:
            return 0
        return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=self.gen))

