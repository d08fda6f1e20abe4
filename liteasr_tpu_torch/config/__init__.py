"""Config schema + composition engine (copy of liteasr_tpu/config).

The schema is the reference's, for training and inference, so that a
config written by either package composes here unchanged. Options the port
does not have raise where they are read: a ``distributed`` layout that does
not fit the processes (``parallel/mesh.py`` ``check_layout``), a tp that
does not divide the sharded widths (``parallel/sharding.py``
``check_widths``), another ``model.dec_arch`` (``models/u2.py`` and
``models/transducer.py``, ``build_model``) and an unknown decode mode
(``decode.py`` ``decode_batch``). ``common.prng_impl`` and
``common.compile_cache_dir`` are JAX settings, accepted and without effect.
"""

from liteasr_tpu_torch.config.core import (  # noqa: F401
    MISSING,
    II,
    ConfigStore,
    DotDict,
    compose,
    load_yaml,
    resolve,
    to_dict,
    to_yaml,
)

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class LiteasrDataclass:
    name: Optional[str] = None


@dataclass
class TriggerConfig(LiteasrDataclass):
    """One trainer event: run method ``name`` every ``interval`` ``unit``s."""

    interval: int = 1
    unit: str = "epoch"  # epoch | iteration


@dataclass
class CommonConfig(LiteasrDataclass):
    seed: int = 1
    trigger: List[TriggerConfig] = field(default_factory=list)
    # stage the batchified train set to <train dir>/.dump, read it back lazily
    memory_save: bool = False
    run_dir: str = "."  # where train.log / infer.log / config.yaml land
    log_level: str = "INFO"
    profile_dir: Optional[str] = None  # torch.profiler Chrome trace of the run
    resume: Optional[str] = None  # auto | path of a train_state.pt
    prng_impl: str = "rbg"  # a JAX PRNG setting: no effect here
    compile_cache_dir: Optional[str] = None  # a JAX setting: no effect here
    # JSONL rows: one run_meta row at startup, one row per validation
    results_file: Optional[str] = None


@dataclass
class DatasetConfig(LiteasrDataclass):
    """Batching knobs the test-set loader reads (liteasr_tpu/config)."""

    batch_count: str = "seq"  # seq | frame
    batch_size: Optional[int] = None
    min_batch_size: Optional[int] = 1
    max_len_in: Optional[int] = None
    max_len_out: Optional[int] = None
    max_frame_in: Optional[int] = None
    max_frame_out: Optional[int] = None
    max_frame_inout: Optional[int] = None
    # pad each decode batch's time axis up to a multiple of this
    pad_time_multiple: int = 128
    pad_label_multiple: int = 16
    bucket_ladder: bool = False
    num_workers: int = 2  # host-side prefetch threads
    crop_multiple: int = 8000
    pad_batch_multiple: int = 4
    # on-the-fly log-mel features of wav.scp waveforms, on the device
    fbank: bool = False
    num_mel_bins: int = 80


@dataclass
class SpecAugmentConfig:
    time_warp: int = 80
    time_warp_mode: str = "bicubic"
    freq_mask: int = 27
    freq_mask_times: int = 1
    time_mask: int = 100
    time_mask_times: int = 1
    inplace: bool = True
    replace_with_zero: bool = False


@dataclass
class PostProcessConfig(LiteasrDataclass):
    spec_aug: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    workflow: List[str] = field(default_factory=lambda: ["spec_aug"])
    # true: augment on the device inside the train step
    # (ops/spec_augment.py); false: per utterance on the host
    on_device: bool = True


@dataclass
class DistributedConfig(LiteasrDataclass):
    """Device layout; the port trains on one device (dp, tp, sp > 1 raise)."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    num_workers: int = 2
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass
class OptimizationConfig(LiteasrDataclass):
    max_epoch: int = -1
    max_iter: int = -1
    accum_grad: int = 1
    clip_grad_norm: float = 0.0
    dtype: str = "bfloat16"
    # the port has one optimizer path (optims/fused_step.py), whatever this says
    fused_step: bool = False


@dataclass
class InferenceConfig(LiteasrDataclass):
    """Reference: liteasr/config/__init__.py:82-88."""

    ckpt_path: str = II("task.save_dir")
    ckpt_name: Optional[int] = MISSING
    model_avg: bool = False
    avg_num: int = 1
    avg_policy: Optional[str] = II("common.run_dir")
    batch_size: int = 8  # utterances decoded per device batch
    beam_size: int = 10
    ctc_weight: float = 0.5
    # transducer beam: non-blank expansion rounds per encoder frame
    expansions_per_frame: int = 5


@dataclass
class LiteasrConfig(LiteasrDataclass):
    common: CommonConfig = field(default_factory=CommonConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    postprocess: PostProcessConfig = field(default_factory=PostProcessConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    task: Any = None
    model: Any = None
    criterion: Any = None
    optimizer: Any = None


def config_init() -> None:
    """Register the root schema (reference: liteasr/train.py:36-38)."""
    ConfigStore.instance().store(name="liteasr_config", node=LiteasrConfig)
