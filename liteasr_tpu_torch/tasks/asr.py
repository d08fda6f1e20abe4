"""ASR task (liteasr_tpu/tasks/asr.py; reference liteasr/tasks/asr.py:23-98)."""

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from liteasr_tpu_torch.config import MISSING, LiteasrDataclass
from liteasr_tpu_torch.data.dataset import AudioFileDataset
from liteasr_tpu_torch.data.vocab import SPACE, Vocab
from liteasr_tpu_torch.tasks import LiteasrTask, register_task

logger = logging.getLogger(__name__)


@dataclass
class ASRConfig(LiteasrDataclass):
    vocab: str = MISSING
    train: str = MISSING
    valid: str = MISSING
    test: List[str] = field(default_factory=list)
    delimiter: Optional[str] = None
    save_dir: str = "ckpts"


@register_task("asr", dataclass=ASRConfig)
class ASRTask(LiteasrTask):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.vocab = Vocab(cfg.vocab)
        self.save_dir = cfg.save_dir
        Path(self.save_dir).mkdir(parents=True, exist_ok=True)
        self.vocab_size = len(self.vocab)
        self.feat_dim = 0

    def load_dataset(self, split, data_dir, dataset_cfg=None,
                     postprocess_cfg=None, memory_save: bool = False):
        assert split in ("train", "valid", "test")
        dirs = [data_dir] if isinstance(data_dir, str) else data_dir
        if not isinstance(dirs, (list, tuple)):
            raise TypeError(f"data_dir with type {type(data_dir)} cannot be parsed")
        sets = []
        for d_dir in dirs:
            logger.info("loading %s data from %s", split, d_dir)
            sets.append(AudioFileDataset(
                split=split,
                data_dir=d_dir,
                delimiter=self.cfg.delimiter,
                dataset_cfg=dataset_cfg,
                postprocess_cfg=postprocess_cfg,
                vocab=self.vocab,
                keep_raw=split == "test",
                memory_save=memory_save,
            ))
        self.datasets[split] = sets[0] if isinstance(data_dir, str) else sets
        self.feat_dim = sets[0].feat_dim

    def ids_to_text(self, tokenids) -> str:
        tokens = self.vocab.lookupi(tokenids, convert=True)
        if self.cfg.delimiter is None:
            return "".join(tokens)
        return self.cfg.delimiter.join(tokens)

    def inference(self, x, model) -> str:
        """Single-utterance decode helper: features (T, F) on the model's
        device, text out (the batched path is ``infer.infer_dataset``)."""
        from liteasr_tpu_torch import decode

        return self.ids_to_text(decode.decode_utterance(model, x))

    def normalize_ref(self, text: str) -> str:
        """Render a raw transcript the way ``ids_to_text`` renders
        hypotheses (``<space>`` -> " "), as liteasr_tpu/tasks/asr.py does."""
        if self.cfg.delimiter is None:
            return text
        toks = [" " if t == SPACE else t
                for t in text.split(self.cfg.delimiter)]
        return self.cfg.delimiter.join(toks)
