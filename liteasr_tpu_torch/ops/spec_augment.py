"""Batched SpecAugment on the device (liteasr_tpu/ops/spec_augment.py:30-187).

Split in two so that the augmentation is a pure function of its draws:

* :func:`draw` takes every random number of a batch from one
  ``torch.Generator`` on the batch's device, with the reference's sampling:
  the time-warp center in [W, max(xlen - W, W + 1)) and the warped point
  in [center - W + 1, center + W], clipped to [1, xlen - 1]; for each mask
  a bound and a width, both uniform in [0, param), and a start uniform in
  [0, max(size - bound, 1)), where size is the feature dim or xlen;
* :func:`apply` warps and masks a padded batch (B, T, D) with those draws:
  the PIL-parity bicubic warp (Keys a = -0.5, pixel-centre alignment, the
  support clipped to each segment and the weights renormalised, at most
  ``K_TAPS`` taps) or the piecewise-linear one, no warp for an utterance
  too short for it, then the frequency masks filled with the valid region's
  mean (or 0), then the time masks filled with the mean after the
  frequency masks. Padding rows stay untouched.

:func:`step_generator` seeds the generator from (seed, step), as the JAX
trainer folds its SpecAugment key from the step: a resumed run draws what
an uninterrupted one would.
"""

from typing import Dict

import torch

K_TAPS = 12  # taps per output row: exact PIL parity up to a 2.75x downscale


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of the ``step``-th train step's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step) * 7919 + 17) % (1 << 62))
    return gen


def _uniform_int(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """floor(lo + u (hi - lo)) in [lo, hi) for u in [0, 1) (hi > lo)."""
    n = hi - lo
    return lo + torch.minimum(torch.floor(u * n).long(), n - 1)


def draw(xlens: torch.Tensor, feat_dim: int, generator: torch.Generator,
         time_warp: int = 5, freq_mask: int = 30, freq_mask_times: int = 2,
         time_mask: int = 40, time_mask_times: int = 2) -> Dict[str, torch.Tensor]:
    """Every draw of one batch, as int64 tensors on ``xlens``'s device:
    ``center``/``warped`` (B,), ``freq_start``/``freq_width`` (B,
    freq_mask_times) and ``time_start``/``time_width`` (B,
    time_mask_times)."""
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


def _keys_cubic(t: torch.Tensor) -> torch.Tensor:
    """PIL's BICUBIC kernel: Keys cubic, a = -0.5."""
    at = t.abs()
    near = (1.5 * at - 2.5) * at * at + 1.0
    far = ((-0.5 * at + 2.5) * at - 4.0) * at + 2.0
    return torch.where(at < 1.0, near, torch.where(at < 2.0, far, 0.0))


def warp_bicubic(x, xlen, center, warped):
    """``_warp_bicubic`` for a batch: x (B, T, D); xlen, center, warped
    (B,). Rows [0, center) are resampled onto [0, warped) and [center,
    xlen) onto [warped, xlen), as PIL's ``Image.resize(BICUBIC)``; rows past
    xlen are untouched."""
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
    p = pmin[..., None] + torch.arange(K_TAPS, device=x.device)  # (B, T, K)
    w = _keys_cubic((p.float() + 0.5 - c[..., None]) / fscale[..., None])
    w = torch.where(p < pmax[..., None], w, 0.0)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    rows = torch.gather(x.float(), 1, p.clamp(0, T - 1).reshape(B, T * K_TAPS, 1)
                        .expand(B, T * K_TAPS, D)).reshape(B, T, K_TAPS, D)
    out = torch.einsum("btk,btkd->btd", w, rows).to(x.dtype)
    return torch.where((i < xlen)[..., None], out, x)


def warp_linear(x, xlen, center, warped):
    """``_warp_linear`` for a batch: a piecewise-linear coordinate remap
    with 2-tap interpolation; rows past xlen are untouched."""
    B, T, D = x.shape
    dst = torch.arange(T, device=x.device, dtype=torch.float32)[None, :]
    xlen, center, warped = (a.long()[:, None] for a in (xlen, center, warped))
    left_src = dst * (center.float() / torch.clamp(warped.float(), min=1.0))
    right_ratio = ((xlen - center).float()
                   / torch.clamp((xlen - warped).float(), min=1.0))
    right_src = center + (dst - warped) * right_ratio
    src = torch.where(dst < warped, left_src, right_src)
    src = torch.where(dst >= xlen, dst, src).clamp(0.0, T - 1.0)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=T - 1)
    frac = (src - lo)[..., None]

    def rows(idx):
        return torch.gather(x, 1, idx[..., None].expand(B, T, D))

    return (1.0 - frac) * rows(lo) + frac * rows(hi)


def _valid_mean(x, xlen):
    """Mean over each utterance's first xlen frames, (B, 1, 1)."""
    valid = (torch.arange(x.shape[1], device=x.device)[None, :] < xlen[:, None])
    total = (x * valid[..., None]).sum(dim=(1, 2))
    return (total / torch.clamp(xlen * x.shape[2], min=1))[:, None, None]


def _mask(x, xlen, start, width, along_time: bool, replace_with_zero: bool):
    """Fill [start, start + width) of each draw along time (inside xlen)
    or frequency with the valid mean, taken once before these masks."""
    fill = 0.0 if replace_with_zero else _valid_mean(x, xlen)
    n = x.shape[1] if along_time else x.shape[2]
    idx = torch.arange(n, device=x.device)[None, None, :]
    hit = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    if along_time:
        hit = hit & (idx < xlen[:, None, None])
    hit = hit.any(dim=1)  # (B, n)
    hit = hit[:, :, None] if along_time else hit[:, None, :]
    return torch.where(hit, fill, x)


def apply(xs: torch.Tensor, xlens: torch.Tensor, draws: Dict[str, torch.Tensor],
          time_warp: int = 5, time_warp_mode: str = "bicubic",
          replace_with_zero: bool = False) -> torch.Tensor:
    """SpecAugment of a padded batch (B, T, D) with ``draws`` from
    :func:`draw`: the time warp (if ``time_warp`` > 0), then the frequency
    and the time masks (as many as the draws hold)."""
    xl = xlens.long()
    if time_warp > 0:
        warp = {"bicubic": warp_bicubic, "linear": warp_linear}.get(time_warp_mode)
        if warp is None:
            raise ValueError(f"unknown time_warp_mode {time_warp_mode!r}")
        out = warp(xs, xl, draws["center"], draws["warped"])
        too_short = (xl - time_warp <= time_warp)[:, None, None]
        xs = torch.where(too_short, xs, out)
    for name in ("freq", "time"):
        if draws[f"{name}_start"].shape[1]:
            xs = _mask(xs, xl, draws[f"{name}_start"], draws[f"{name}_width"],
                       name == "time", replace_with_zero)
    return xs


def spec_augment(xs: torch.Tensor, xlens: torch.Tensor, generator: torch.Generator,
                 time_warp: int = 5, freq_mask: int = 30, freq_mask_times: int = 2,
                 time_mask: int = 40, time_mask_times: int = 2,
                 replace_with_zero: bool = False,
                 time_warp_mode: str = "bicubic") -> torch.Tensor:
    """Draw from ``generator``, then apply: the reference's ``spec_augment``
    (a parameter or count of 0 turns that part off)."""
    draws = draw(xlens, xs.shape[2], generator, time_warp, freq_mask,
                 freq_mask_times if freq_mask > 0 else 0, time_mask,
                 time_mask_times if time_mask > 0 else 0)
    return apply(xs, xlens, draws, time_warp, time_warp_mode, replace_with_zero)
