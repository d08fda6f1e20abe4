"""Attention and span masks (liteasr_tpu/ops/masks.py). True = MASKED.

``padding_mask`` / ``triangle_mask`` are torch; ``span_mask`` (wav2vec 2.0
span masking, the reference's host allocator) runs on numpy's RNG, as the
reference's does, and is the oracle that the model's on-device span mask
(:func:`liteasr_tpu_torch.models.wav2vec2.device_span_mask`) is held to.
"""

from typing import Optional

import numpy as np
import torch


def padding_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, max_len) bool, True at padded positions.

    >>> padding_mask(torch.tensor([5, 3, 1]), 5).int()
    tensor([[0, 0, 0, 0, 0],
            [0, 0, 0, 1, 1],
            [0, 1, 1, 1, 1]], dtype=torch.int32)
    """
    base = torch.arange(max_len, device=lens.device)[None, :]
    return base >= lens[:, None]


def triangle_mask(row: int, col: int = 0, stage: int = 1, diagonal: int = 1,
                  device=None) -> torch.Tensor:
    """Chunked causal mask, (row, col) bool; True = masked (future beyond
    the chunk boundary). ``stage`` is the WeNet-style chunk width."""
    col = row if col == 0 else col
    row_idx = torch.arange(row, device=device)[:, None]
    col_idx = torch.arange(col, device=device)[None, :]
    return (col_idx // stage) > (row_idx // stage) + (diagonal - 1)


def span_mask(
    batch: int,
    frame: int,
    prob: float,
    length: int,
    policy: str = "static",
    no_overlap: bool = False,
    min_mask_num: int = 0,
    min_interval: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random span mask for wav2vec2 pretraining (True = masked).

    Host-side numpy implementation with the same policies as the reference
    (liteasr/utils/mask.py:93-230): static/uniform/normal/poisson span widths,
    optional no-overlap allocation with a minimum gap, and per-batch mask-count
    equalization.
    """
    rng = rng or np.random.default_rng()
    mask = np.zeros((batch, frame), dtype=bool)

    mask_num = int(prob * frame / float(length) + rng.random())
    mask_num = max(min_mask_num, mask_num)

    mask_idcs = []
    for _ in range(batch):
        if policy == "static":
            spans = np.full(mask_num, length)
        elif policy == "uniform":
            spans = rng.integers(0, length * 2 + 1, size=mask_num)
        elif policy == "normal":
            spans = np.maximum(1, np.round(rng.normal(length, 0.0, size=mask_num))
                               ).astype(int)
        elif policy == "poisson":
            spans = np.round(rng.poisson(length, size=mask_num)).astype(int)
        else:
            raise ValueError(f"unknown mask selection {policy}")

        if spans.sum() == 0:
            spans[0] = min(length, frame - 1)

        if no_overlap:
            idx: list = []
            keep = int(spans.min())

            def place(start: int, end: int, size: int):
                span_start = int(rng.integers(start, end - size))
                idx.extend(range(span_start, span_start + size))
                segments = []
                if start + keep + min_interval <= span_start:
                    segments.append((start, span_start - min_interval + 1))
                if span_start + size + min_interval + keep < end:
                    segments.append((span_start + size + min_interval, end))
                return segments

            segments = [(0, frame)]
            for size in sorted(spans, reverse=True):
                size = int(size)
                seg_lens = np.array(
                    [e - s if e - s >= size + min_interval else 0
                     for s, e in segments], dtype=float)
                total = seg_lens.sum()
                if total == 0:
                    break
                which = rng.choice(len(segments), p=seg_lens / total)
                s, e = segments.pop(which)
                segments.extend(place(s, e, size))
            mask_idc = np.asarray(idx, dtype=int)
        else:
            min_span = int(spans.min())
            if frame - min_span <= mask_num:
                min_span = frame - mask_num - 1
            starts = rng.choice(frame - min_span, mask_num, replace=False)
            mask_idc = np.asarray(
                [starts[j] + off for j in range(len(starts))
                 for off in range(int(spans[j]))], dtype=int)

        mask_idcs.append(np.unique(mask_idc[mask_idc < frame]))

    # equalize masked counts across the batch (fixed-shape gather downstream)
    min_len = min(len(m) for m in mask_idcs)
    for i, mask_idc in enumerate(mask_idcs):
        if len(mask_idc) > min_len:
            mask_idc = rng.choice(mask_idc, min_len, replace=False)
        mask[i, mask_idc] = True
    return mask
