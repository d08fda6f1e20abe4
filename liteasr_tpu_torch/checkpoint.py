"""Checkpoint loading for inference (liteasr_tpu/checkpoint.py:118-127).

A checkpoint is one ``model.ep.<N>.pt`` file holding the model's
``state_dict`` (``torch.save``). Averaging (``inference.model_avg``) is not
ported yet and raises.
"""

import logging
import os
from typing import Dict

import torch

logger = logging.getLogger(__name__)

CKPT_TEMPLATE = "model.ep.{}.pt"


def load_ckpt(infer_cfg) -> Dict[str, torch.Tensor]:
    """Load the model state_dict named by ``inference.ckpt_path`` and
    ``inference.ckpt_name``."""
    if infer_cfg.model_avg:
        raise NotImplementedError(
            "inference.model_avg=true: checkpoint averaging is not ported yet; "
            "pass inference.model_avg=false")
    path = os.path.join(infer_cfg.ckpt_path,
                        CKPT_TEMPLATE.format(infer_cfg.ckpt_name))
    logger.info("loading checkpoint: %s", path)
    return torch.load(path, map_location="cpu", weights_only=True)
