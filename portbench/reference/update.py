"""The plain reference through a cell's checked micro-steps, for any model
of the benchmark: the seed's fp32 leaves, each micro-step's loss and
gradients from a model's own step, the first gradient's leaf norms, and
each leaf's change after one clipped Adam update at the port's Noam rate
on the mean gradient. Imports nothing of the port.
"""

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

import weights
from reference import draws
from reference.u2 import adam_update, noam_lr

# one micro-step: (leaves, its index, its batch on the device) -> (loss, grads)
Step = Callable[[Dict[str, torch.Tensor], int, Dict[str, torch.Tensor]],
                Tuple[float, Dict[str, torch.Tensor]]]


def device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """A collated batch's arrays on ``device``, the ids as int64."""
    b = {key: torch.from_numpy(np.asarray(v)).to(device) for key, v in batch.items()}
    for key in ("ys", "xlens", "ylens"):
        b[key] = b[key].long()
    return b


def spec_augment(xs, xlens, cfg, generator):
    """``draws.spec_augment`` with the composed config's ``postprocess.spec_aug``."""
    sa = cfg.postprocess.spec_aug
    return draws.spec_augment(
        xs, xlens, generator, time_warp=int(sa.time_warp), freq_mask=int(sa.freq_mask),
        freq_mask_times=int(sa.freq_mask_times), time_mask=int(sa.time_mask),
        time_mask_times=int(sa.time_mask_times), replace_with_zero=bool(sa.replace_with_zero),
        time_warp_mode=str(sa.time_warp_mode))


def follow(seed: int, device, cfg, batches: List, lay, step: Step) -> Dict:
    """Each micro-step's loss, the first one's gradient leaf norms, and the
    norm of every leaf's change after the update at the last one, from the
    leaves of ``lay`` drawn from ``seed``."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    P = {n: t.requires_grad_(True) for n, t in weights.draw(lay, seed, device).items()}
    total = {n: torch.zeros_like(t) for n, t in P.items()}
    losses, first = [], None
    for k, batch in enumerate(batches):
        loss, grads = step(P, k, device_batch(batch, device))
        losses.append(loss)
        for n, g in grads.items():
            total[n] += g
        if k == 0:
            first = {n: float(grads[n].norm()) for n in P}
        del grads
    opt = cfg.optimizer
    lr = noam_lr(0, int(opt.model_dim), float(opt.factor), int(opt.warmup))
    with torch.no_grad():
        mean = {n: g / len(batches) for n, g in total.items()}
        after = adam_update({n: t.detach() for n, t in P.items()}, mean, lr,
                            float(opt.beta1), float(opt.beta2), float(opt.eps),
                            float(cfg.optimization.clip_grad_norm))
        change = {n: float((after[n] - P[n].detach()).norm()) for n in P}
    return {"loss": losses, "aux": [{} for _ in batches], "grad": first, "change": change}
