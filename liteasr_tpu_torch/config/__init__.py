"""Config schema + composition engine (copy of liteasr_tpu/config).

Only the schema that inference reads is ported: ``common``, ``dataset`` and
``inference``. Sections a training run writes into its ``config.yaml``
(``postprocess``, ``optimization``, ...) still pass through composition as
plain dicts.
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
from typing import Any, Optional


@dataclass
class LiteasrDataclass:
    name: Optional[str] = None


@dataclass
class CommonConfig(LiteasrDataclass):
    seed: int = 1
    run_dir: str = "."  # where infer.log lands
    log_level: str = "INFO"


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
    # on-the-fly features from wav.scp waveforms: not ported (raises)
    fbank: bool = False
    num_mel_bins: int = 80


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


@dataclass
class LiteasrConfig(LiteasrDataclass):
    common: CommonConfig = field(default_factory=CommonConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    task: Any = None
    model: Any = None
    criterion: Any = None
    optimizer: Any = None


def config_init() -> None:
    """Register the root schema (reference: liteasr/train.py:36-38)."""
    ConfigStore.instance().store(name="liteasr_config", node=LiteasrConfig)
