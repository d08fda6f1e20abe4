"""Pretrain driver: wav2vec 2.0 micro-steps of the port's
``Trainer.train_step`` on raw-wave batches from the port's data path
(``RawAudioFileDataset``'s ``Wav2VecBatch`` batchify and its crop-to-the-
shortest collator), through the train driver's loop, set-up and check;
the reference is ``reference/w2v2.py``, which follows the port's span
mask, negatives and Gumbel draws.
"""

from typing import Dict, List

import numpy as np
import torch

import flops
import generator
import harness
import weights
from reference import draws, w2v2 as ref_w2v2
from reference.u2 import Ops, adam_update

train = harness.load_module("drivers", "train")

# the configuration's sizes that the port takes as ``model.*`` overrides
MODEL_KEYS = ("encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
              "encoder_attention_heads", "conv_pos", "conv_pos_groups", "latent_vars",
              "latent_groups", "num_negatives", "mask_prob", "mask_length", "dropout",
              "attention_dropout", "dropout_input", "dropout_features", "logit_temp",
              "final_dim")


def in_memory_waves(cfg, utts):
    """The port's ``RawAudioFileDataset`` over waves held in memory."""
    from liteasr_tpu_torch.data.dataset import RawAudioFileDataset

    ds = RawAudioFileDataset.__new__(RawAudioFileDataset)
    ds.data = utts
    ds.batchify_policy = None
    ds.dataset_cfg = cfg.dataset
    ds.crop_frames = 250000
    ds.batch_multiple, ds.num_shards, ds.shard_index = 1, 1, 0
    ds.split, ds.feat_dim = "train", 1
    ds.batchify(cfg.dataset)
    return ds


class W2V2Family:
    kind = "train"
    attn_kernels = ()  # the training attention is plain PyTorch: no kernel to read
    aux_keys = ("code_ppl",)  # the criterion's codebook perplexity, compared too

    def __init__(self, cell: harness.Cell):
        self.cell, self.m, self.mix = cell, cell.config["model"], cell.traffic

    def overrides(self) -> List[str]:
        conv = self.m["conv_feature_layers"].replace(" ", "")
        return (list(self.cell.config["port"]["train"]) + list(self.mix["port"])
                + [f"model.{k}={self.m[k]}" for k in MODEL_KEYS]
                + [f'model.conv_feature_layers="{conv}"',
                   f"common.seed={self.cell.seed}", "common.trigger=[]",
                   f"task.save_dir={harness.ROOT / 'build' / 'portbench' / 'ckpts'}"])

    def dataset(self, cfg):
        return in_memory_waves(cfg, generator.waves(self.mix, self.cell.seed))

    def shape_key(self, batch) -> tuple:
        return tuple(batch["xs"].shape)

    def shape_keys(self, ds, cfg) -> set:
        return {tuple(ds.collator(ds[i])["xs"].shape) for i in range(len(ds))}

    def layout(self):
        return ref_w2v2.layout(self.m)

    def weights(self, lay):
        return weights.draw(lay, self.cell.seed, self.cell.device)

    def record(self, batch):
        return batch["xs"].shape, int(batch["valid"].sum())

    def summarize(self, records) -> Dict[str, float]:
        m = self.m
        sizes = dict(dim=m["encoder_embed_dim"], layers=m["encoder_layers"],
                     final_dim=m["final_dim"] or m["encoder_embed_dim"],
                     groups=m["latent_groups"], codes=m["latent_vars"])
        real = sum(T * rows for (_, T), rows in records)
        return {"audio_s": generator.audio_seconds(real, self.mix), "real_frames": real,
                "padded_frames": sum(B * T for (B, T), _ in records),
                "flops": sum(flops.w2v2_train_flops(rows, T, **sizes)
                             for (_, T), rows in records)}

    def attn_bound_s(self, batch) -> float:
        return 0.0

    def follow(self, cfg, batches, precision: str) -> Dict:
        """The plain reference through the checked micro-steps, as the U2
        follower: each loss and code perplexity, the first gradient's leaf
        norms, the change of every leaf after the update at the last one."""
        cell, m = self.cell, self.m
        dev = cell.device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        lay = ref_w2v2.layout(m)
        P = {n: t.requires_grad_(True) for n, t in weights.draw(lay, cell.seed, dev).items()}
        model = ref_w2v2.W2V2Reference(m, Ops(precision))
        rng = ref_w2v2.Draws(cell.seed)
        total = {n: torch.zeros_like(t) for n, t in P.items()}
        losses, aux, first = [], [], None
        for k, batch in enumerate(batches):
            b = {key: torch.from_numpy(np.asarray(v)).to(dev) for key, v in batch.items()}
            b["xlens"] = b["xlens"].long()
            loss, ppl = model.loss(P, b, draws.Dropouts(cell.seed, k, dev), rng, k,
                                   float(cfg.criterion.diversity_weight))
            grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
            losses.append(float(loss.detach()))
            aux.append({"code_ppl": float(ppl)})
            for (n, _), g in zip(P.items(), grads):
                if g is not None:
                    total[n] += g
            if k == 0:
                first = {n: (0.0 if g is None else float(g.norm()))
                         for (n, _), g in zip(P.items(), grads)}
            del loss, grads
        opt = cfg.optimizer
        with torch.no_grad():
            mean = {n: g / len(batches) for n, g in total.items()}
            after = adam_update({n: t.detach() for n, t in P.items()}, mean, float(opt.lr),
                                float(opt.beta1), float(opt.beta2), float(opt.eps),
                                float(cfg.optimization.clip_grad_norm))
            change = {n: float((after[n] - P[n].detach()).norm()) for n in P}
        return {"loss": losses, "aux": aux, "grad": first, "change": change}


def run(cell: harness.Cell) -> harness.Run:
    return train.run_family(cell, W2V2Family(cell))
