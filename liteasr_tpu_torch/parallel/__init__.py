"""Data, sequence and tensor parallelism across processes
(liteasr_tpu/parallel/__init__.py); the Megatron and sequence shards are in
:mod:`.sharding`."""

from liteasr_tpu_torch.parallel.mesh import (  # noqa: F401
    Layout,
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
    layout,
    process_count,
    process_index,
    rank_seed,
    seed_streams,
    set_stream_states,
    stream,
    stream_states,
)
