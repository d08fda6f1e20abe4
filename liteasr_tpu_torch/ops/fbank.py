"""Log-mel filterbank front end with per-utterance CMVN, on the batch's
device (liteasr_tpu/ops/fbank.py:19-110).

Kaldi-style framing (25 ms windows every 10 ms at 16 kHz), per-frame DC
removal, preemphasis 0.97, the povey window, the power spectrum of a
512-point ``torch.fft.rfft``, a product with the triangular mel matrix, a
log floored at 1e-10 and mean/variance normalisation over each utterance's
valid frames, its statistics taken in fp64 (the reference's fp32 turns the
rounding of a constant bin's mean into noise of up to ~0.02 after
``rsqrt(var + 1e-8)``; here such a bin is 0). Plain PyTorch: cuFFT and one
matmul on the card.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch


def mel_filterbank(num_bins: int, n_fft: int, sample_rate: int,
                   low_freq: float = 20.0,
                   high_freq: Optional[float] = None) -> np.ndarray:
    """(n_fft//2+1, num_bins) triangular mel filter matrix (HTK mel scale)."""
    high_freq = high_freq or sample_rate / 2.0

    def hz_to_mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz) / 700.0)

    def mel_to_hz(mel):
        return 700.0 * (np.exp(np.asarray(mel) / 1127.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(low_freq), hz_to_mel(high_freq),
                          num_bins + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mel_pts) / sample_rate).astype(int)

    fb = np.zeros((n_fft // 2 + 1, num_bins), dtype=np.float32)
    for m in range(num_bins):
        lo, ctr, hi = bins[m], bins[m + 1], bins[m + 2]
        for k in range(lo, ctr):
            fb[k, m] = (k - lo) / (ctr - lo)
        for k in range(ctr, hi):
            fb[k, m] = (hi - k) / (hi - ctr)
    return fb


def num_frames(num_samples: int, frame_length: int = 400,
               frame_shift: int = 160) -> int:
    if num_samples < frame_length:
        return 0
    return 1 + (num_samples - frame_length) // frame_shift


def log_mel_fbank(
    waveform: torch.Tensor,
    wave_lens: torch.Tensor,
    num_mel_bins: int = 80,
    frame_length: int = 400,
    frame_shift: int = 160,
    n_fft: int = 512,
    sample_rate: int = 16000,
    preemph: float = 0.97,
    cmvn: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:param waveform: (B, S) float in [-1, 1], on any device
    :param wave_lens: (B,) valid samples
    :return: (feats (B, T, num_mel_bins) fp32, feat_lens (B,) int32), T =
        ``num_frames(S)``; frames past an utterance's length are 0 with
        ``cmvn``.
    """
    dev = waveform.device
    B, S = waveform.shape
    T = num_frames(S, frame_length, frame_shift)
    frames = waveform.float().unfold(1, frame_length, frame_shift)[:, :T]  # (B, T, L)

    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemph * pre
    n = torch.arange(frame_length, dtype=torch.float32, device=dev)
    povey = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (frame_length - 1))) ** 0.85
    frames = frames * povey

    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()  # (B, T, n_fft//2+1)
    fb = torch.from_numpy(mel_filterbank(num_mel_bins, n_fft, sample_rate)).to(dev)
    feats = torch.log(torch.clamp(torch.matmul(power, fb), min=1e-10))

    wave_lens = wave_lens.to(dev)
    feat_lens = torch.where(
        wave_lens >= frame_length,
        1 + torch.div(wave_lens - frame_length, frame_shift, rounding_mode="floor"),
        0).to(torch.int32)

    if cmvn:  # statistics in fp64: a constant bin (an empty filter) gives 0
        f64 = feats.double()
        valid = (torch.arange(T, device=dev)[None, :] < feat_lens[:, None])[..., None]
        denom = torch.clamp(feat_lens, min=1).double()[:, None, None]
        mean = (f64 * valid).sum(dim=1, keepdim=True) / denom
        var = (((f64 - mean) ** 2) * valid).sum(dim=1, keepdim=True) / denom
        feats = ((f64 - mean) * torch.rsqrt(var + 1e-8) * valid).float()
    return feats, feat_lens
