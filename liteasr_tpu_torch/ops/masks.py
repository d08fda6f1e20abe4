"""Attention masks (liteasr_tpu/ops/masks.py:17-49). True = MASKED."""

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
