"""wav2vec 2.0 pretraining task (liteasr_tpu/tasks/pretrain.py): raw-wave
batches of :class:`~liteasr_tpu_torch.data.dataset.RawAudioFileDataset`
(the crop-to-shortest collator, weight-0 dummy rows), no vocabulary."""

import logging
from dataclasses import dataclass
from pathlib import Path

from liteasr_tpu_torch.config import MISSING, LiteasrDataclass
from liteasr_tpu_torch.data.dataset import RawAudioFileDataset
from liteasr_tpu_torch.tasks import LiteasrTask, register_task

logger = logging.getLogger(__name__)


@dataclass
class PreTrainConfig(LiteasrDataclass):
    train: str = MISSING
    valid: str = MISSING
    save_dir: str = "ckpts"


@register_task("pretrain", dataclass=PreTrainConfig)
class PreTrainTask(LiteasrTask):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.save_dir = cfg.save_dir
        Path(self.save_dir).mkdir(parents=True, exist_ok=True)

    def load_dataset(self, split, data_dir, dataset_cfg=None,
                     postprocess_cfg=None, memory_save: bool = False):
        assert split in ("train", "valid")
        logger.info("loading %s data from %s", split, data_dir)
        self.datasets[split] = RawAudioFileDataset(data_dir, dataset_cfg, postprocess_cfg)
