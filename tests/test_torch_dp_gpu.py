"""A process group of one rank over NCCL on the card, without JAX (so the
card, which has no JAX, runs it with ``python -m pytest --noconftest -m gpu
tests/test_torch_dp_gpu.py``).

On the card (marker ``gpu``, skipped without CUDA): one fp32 train step of a
tiny conformer U2 (TF32 off, dropout 0) through the kernels, inside a
one-rank NCCL group and without a group. The group's step runs the
collectives (the BatchNorm statistics and sums, the utterance count, the
flat gradient) and launches K1'/K2 as the ungrouped step does; its
gradients and BatchNorm statistics agree within 1e-5 of each leaf's max (K2
sums dQ/dP with fp32 atomics, so the order of a sum differs from run to
run; the leaves whose gradient is 0 in exact arithmetic are held to the
largest gradient).
"""

import numpy as np
import pytest
import torch

import torch_dp_worker as w

TOL = 1e-5
ZERO_LEAVES = (".conv.depthwise_conv.bias", ".linear_k.bias")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _step(dev):
    """Gradients (after the optimizer's flat all-reduce) and the running
    statistics of one step, with the K1'/K2 launches and the collectives."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.ops import flash_attention as fa
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule
    from liteasr_tpu_torch.trainer import to_device

    model, crit, batch, _ = w.build_case("hybrid_ctc")
    model.to(dev)
    params = list(model.parameters())
    tx = FusedAdam(params, constant_schedule(0.0), 0.9, 0.999, 1e-8)
    flat = []
    tx._step = flat.append  # the gradient the update would take
    fa.flash_attention.lse_launches = fa.flash_rel_attention_bwd.launches = 0
    parallel.counts.clear()
    loss, _ = crit(model, to_device(batch, dev), train=True)
    loss.backward()
    tx.update([p.grad for p in params])
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     flat[0].split([p.numel() for p in params])))
    stats = {n: b.cpu() for n, b in model.named_buffers()}
    launches = (fa.flash_attention.lse_launches, fa.flash_rel_attention_bwd.launches)
    return {n: g.cpu() for n, g in grads.items()}, stats, launches, dict(parallel.counts)


@pytest.mark.gpu
def test_one_rank_nccl_step_equals_the_ungrouped_step(cuda):
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict

    ref, ref_stats, ref_launches, ref_counts = _step(cuda)
    parallel.distributed_init(DotDict(coordinator_address=w.free_address(),
                                      num_processes=1, process_id=0), cuda)
    try:
        assert torch.distributed.get_backend() == "nccl"
        got, stats, launches, counts = _step(cuda)
    finally:
        parallel.destroy()
    assert ref_counts == {} and launches == ref_launches == (2, 2)
    assert counts["grad"] == 1 and counts["count"] == 1 and counts["batch_norm"] == 4
    top = max(g.abs().max().item() for g in ref.values())
    for name, g in ref.items():
        diff = (got[name] - g).abs().max().item()
        scale = top if name.endswith(ZERO_LEAVES) else g.abs().max().item()
        assert diff <= TOL * scale + 1e-12, (name, diff, scale)
    for name, s in ref_stats.items():
        np.testing.assert_allclose(stats[name].numpy(), s.numpy(), rtol=TOL,
                                   atol=TOL * s.abs().max().item(), err_msg=name)
