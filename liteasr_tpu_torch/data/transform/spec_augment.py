"""SpecAugment, host-side per-sample (parity with the reference).

Reference: liteasr/utils/transform/spec_augment.py:14-125 — PIL-bicubic time
warp, freq mask, time mask; masked regions filled with the matrix mean unless
``replace_with_zero``.

The production path is the batched on-device version in
:mod:`liteasr_tpu_torch.ops.spec_augment`; this host version exists for reference
parity and for CPU-only pipelines.
"""

import random

import numpy as np

from liteasr_tpu_torch.data.transform import register_transformation

try:
    from PIL import Image
    from PIL.Image import Resampling

    BICUBIC = Resampling.BICUBIC
    _HAVE_PIL = True
except ImportError:  # pragma: no cover - PIL is expected in the image
    _HAVE_PIL = False


@register_transformation("spec_aug")
class SpecAugment:
    def __init__(self, cfg):
        self.cfg = cfg

    def time_warp(self, x: np.ndarray) -> np.ndarray:
        window = self.cfg.time_warp
        t = x.shape[0]
        if t - window <= window:
            return x
        center = random.randrange(window, t - window)
        warped = random.randrange(center - window, center + window) + 1

        if _HAVE_PIL:
            left = np.asarray(Image.fromarray(x[:center]).resize(
                (x.shape[1], warped), BICUBIC))
            right = np.asarray(Image.fromarray(x[center:]).resize(
                (x.shape[1], t - warped), BICUBIC))
        else:
            left = _resize_linear(x[:center], warped)
            right = _resize_linear(x[center:], t - warped)
        out = x if self.cfg.inplace else x.copy()
        out[:warped] = left
        out[warped:] = right
        return out

    def freq_mask(self, x: np.ndarray) -> np.ndarray:
        cloned = x if self.cfg.inplace else x.copy()
        num_mel = cloned.shape[1]
        fs = np.random.randint(
            0, self.cfg.freq_mask, size=(self.cfg.freq_mask_times, 2))
        for f, width in fs:
            if num_mel - f <= 0:
                continue
            f_zero = random.randrange(0, num_mel - f)
            if width == 0:
                continue
            fill = 0.0 if self.cfg.replace_with_zero else cloned.mean()
            cloned[:, f_zero:f_zero + width] = fill
        return cloned

    def time_mask(self, x: np.ndarray) -> np.ndarray:
        cloned = x if self.cfg.inplace else x.copy()
        length = cloned.shape[0]
        ts = np.random.randint(
            0, self.cfg.time_mask, size=(self.cfg.time_mask_times, 2))
        for t, width in ts:
            if length - t <= 0:
                continue
            t_zero = random.randrange(0, length - t)
            if width == 0:
                continue
            fill = 0.0 if self.cfg.replace_with_zero else cloned.mean()
            cloned[t_zero:t_zero + width] = fill
        return cloned

    def __call__(self, x: np.ndarray) -> np.ndarray:
        # own, writable copy (kaldi_io returns read-only frombuffer views)
        x = np.array(x, dtype=np.float32, copy=True)
        assert x.ndim == 2
        x = self.time_warp(x)
        x = self.freq_mask(x)
        x = self.time_mask(x)
        return x


def _resize_linear(x: np.ndarray, new_len: int) -> np.ndarray:
    """Linear time-axis resize fallback when PIL is unavailable."""
    t = x.shape[0]
    if new_len == t:
        return x.copy()
    src = np.linspace(0.0, t - 1.0, new_len)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    frac = (src - lo)[:, None]
    return (1 - frac) * x[lo] + frac * x[hi]
