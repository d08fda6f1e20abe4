"""Clip + NaN-skip + Adam(+schedule) with gradient accumulation: the port's
one optimizer path, with the semantics of ``fused_adam_step`` and
``FusedTx`` (liteasr_tpu/optims/fused_step.py:37-156), documented there as
equal to the Trainer's ``apply_if_finite(chain(clip_by_global_norm,
scale_by_adam, scale_by_schedule(-lr)))`` under ``accumulate_every_k``
(liteasr_tpu/trainer.py:57-134):

* micro-steps add their gradients into an accumulator; every ``accum``-th
  micro-step feeds the MEAN of the window to the update and resets it;
* the global-norm clip is taken on that mean;
* a non-finite mean skips the step: params, mu, nu and the count stay bit
  identical (the skip and clip decisions are device scalars folded into the
  arithmetic, so no step waits on the host), ``notfinite_count`` grows;
* the learning rate is the schedule at the count of steps applied before;
* ``amsgrad`` (``optax.scale_by_amsgrad``, liteasr_tpu/optims/adam.py:31)
  keeps ``nu_max``, the running max of the bias-corrected second moment
  ``nu / (1 - b2^t)``, and divides by its root: ``mu_hat / (sqrt(nu_max) +
  eps)``. That is not ``torch.optim.Adam(amsgrad=True)``, which takes the
  max of the uncorrected moment and corrects afterwards. A skipped step
  leaves ``nu_max`` bit identical too;
* under a process group, the flat gradient is summed over the dp x sp
  ranks at the applying micro-step (after the window's accumulation, before
  the mean, the finiteness check and the clip): the psum of the accumulated
  gradient. Without a group the sum is the identity and launches nothing.
  Under tensor parallelism the flat vector holds the rank's shards
  (``sharded`` marks them) and the tp peers' replicated leaves, which the
  Megatron collectives keep equal; the global norm^2 is the tp sum of the
  sharded leaves' squares plus the replicated leaves' squares once, so the
  clip and the NaN-skip read one number on every rank.

The parameters, moments and accumulator are handled as one flat fp32
vector, so a step is a fixed handful of kernels whatever the number of
leaves; ``torch._foreach_sub_`` writes the update back into the leaves.
The update is in place (the JAX version returns new arrays).
"""

from typing import Callable, List, Optional

import torch

from liteasr_tpu_torch import parallel


class FusedAdam:
    def __init__(self, params: List[torch.Tensor],
                 schedule: Callable[[torch.Tensor], torch.Tensor],
                 b1: float, b2: float, eps: float, clip: float = 0.0,
                 weight_decay: float = 0.0, accum: int = 1,
                 amsgrad: bool = False, sharded: Optional[List[bool]] = None):
        self.params = list(params)
        if not self.params:
            raise ValueError("FusedAdam: no parameters")
        for p in self.params:
            if p.dtype != torch.float32:
                raise TypeError(f"FusedAdam: parameters must be fp32, got {p.dtype}")
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.clip = float(clip or 0.0)
        self.weight_decay = float(weight_decay or 0.0)
        self.accum = max(int(accum), 1)
        self.amsgrad = bool(amsgrad)
        dev = self.params[0].device
        n = sum(p.numel() for p in self.params)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mini_step = 0
        self.mu = torch.zeros(n, device=dev)
        self.nu = torch.zeros(n, device=dev)
        self.acc = torch.zeros(n, device=dev) if self.accum > 1 else None
        self.nu_max = torch.zeros(n, device=dev) if self.amsgrad else None
        # 1.0 over the tp-sharded leaves' elements (None: no tp shards)
        self.shard_weight = None
        if sharded is not None and any(sharded):
            self.shard_weight = torch.cat([
                torch.full((p.numel(),), float(s), device=dev)
                for p, s in zip(self.params, sharded)])

    def _flat(self, grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        return torch.cat([
            (torch.zeros_like(p) if g is None else g).reshape(-1).float()
            for p, g in zip(self.params, grads)])

    @torch.no_grad()
    def update(self, grads: List[Optional[torch.Tensor]]) -> None:
        """One micro-step with the gradients of ``params`` (None = zero)."""
        g = self._flat(grads)
        if self.accum > 1:
            self.acc.add_(g)
            self.mini_step = (self.mini_step + 1) % self.accum
            if self.mini_step:
                return
            g = parallel.global_sum_(self.acc, "grad") / self.accum
            self.acc.zero_()
        else:
            parallel.global_sum_(g, "grad")
        self._step(g)

    def _step(self, g: torch.Tensor) -> None:
        """``fused_adam_step`` on the flat mean gradient ``g``."""
        b1, b2 = self.b1, self.b2
        if self.shard_weight is None:
            gsq = g.square().sum()
        else:
            sq = g.square()
            sharded_sq = parallel.global_sum_(torch.dot(sq, self.shard_weight), "grad_norm",
                                              over="tp")
            gsq = torch.dot(sq, 1.0 - self.shard_weight) + sharded_sq
        finite = torch.isfinite(gsq)  # any inf/nan leaf makes gsq non-finite
        one = torch.ones((), device=g.device)
        if self.clip > 0:
            scale = torch.clamp(self.clip / torch.clamp(gsq.sqrt(), min=1e-12),
                                max=1.0)
        else:
            scale = one
        s = torch.where(finite, scale, 0.0)
        b1e = torch.where(finite, b1, one)
        b2e = torch.where(finite, b2, one)
        lr = self.schedule(self.count)
        new_count = self.count + finite.to(self.count.dtype)
        # a skipped step at count 0 would give 1 - b^0 = 0 and 0/0 = NaN
        t = torch.clamp(new_count, min=1).float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        step_size = torch.where(finite, lr, 0.0)
        # 0 * nan = nan: zero the non-finite elements of a skipped step
        g32 = torch.nan_to_num(g * s, nan=0.0, posinf=0.0, neginf=0.0)
        if self.weight_decay:
            g32 = g32 + self.weight_decay * torch.cat(
                [p.reshape(-1) for p in self.params])
        self.mu.mul_(b1e).add_((1.0 - b1e) * g32)
        self.nu.mul_(b2e).add_((1.0 - b2e) * g32.square())
        nu_hat = self.nu / bc2
        if self.amsgrad:
            self.nu_max = torch.where(finite, torch.maximum(self.nu_max, nu_hat),
                                      self.nu_max)
            nu_hat = self.nu_max
        u = (self.mu / bc1) / (torch.sqrt(nu_hat) + self.eps)
        delta = step_size * u
        torch._foreach_sub_(self.params, [
            d.view_as(p) for d, p in zip(
                delta.split([p.numel() for p in self.params]), self.params)])
        self.notfinite_count += (~finite).to(self.count.dtype)
        self.count = new_count


def constant_schedule(lr: float):
    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.full((), float(lr), device=count.device)

    return schedule


def build_tx(optimizer, optimization_cfg, params,
             sharded: Optional[List[bool]] = None) -> FusedAdam:
    """clip -> Adam or AMSGrad (+schedule), NaN-protected, accumulated over
    ``accum_grad`` (liteasr_tpu/trainer.py:96-134), over ``params``. AMSGrad is the
    optimizer's ``amsgrad`` (only ``adam`` sets it: noam's chain is
    scale_by_adam whatever its config says, liteasr_tpu/optims/noam.py:
    40-49)."""
    ocfg = optimizer.cfg
    schedule = optimizer.schedule or constant_schedule(float(ocfg.lr))
    return FusedAdam(params, schedule, b1=ocfg.beta1, b2=ocfg.beta2,
                     eps=ocfg.eps,
                     clip=float(optimization_cfg.get("clip_grad_norm") or 0.0),
                     weight_decay=float(ocfg.get("weight_decay", 0.0) or 0.0),
                     accum=int(optimization_cfg.get("accum_grad") or 1),
                     amsgrad=optimizer.amsgrad, sharded=sharded)
