"""Data parallelism across processes (liteasr_tpu/parallel/__init__.py)."""

from liteasr_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_object,
    barrier,
    counts,
    destroy,
    distributed_init,
    global_sum,
    global_sum_,
    global_sum_grad,
    is_initialized,
    is_master,
    process_count,
    process_index,
    rank_seed,
)
