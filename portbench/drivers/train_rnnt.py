"""Transducer train driver: micro-steps of the port's ``Trainer.train_step``
over the conformer transducer (``model=my_transducer`` at the
configuration's widths, ``criterion=my_rnnt``) on batches from the port's
data path, through the train driver's loop, set-up and check; the
reference is ``reference/transducer.py``, which computes the joint and the
loss in blocks of rows on the card.
"""

import sys
from typing import Dict, List

import flops
import flops_rnnt
import generator
import harness
from reference import draws, transducer as ref_rnnt
from reference import update
from reference.u2 import Ops

train = harness.load_module("drivers", "train")

# the configuration's keys that the port takes as ``model.*`` overrides
MODEL_KEYS = ("enc_arch", "activation", "use_rel", "enc_dim", "enc_ff_dim",
              "enc_attn_heads", "enc_layers", "dec_dim", "dec_units", "dec_layers",
              "joint_dim", "dropout_rate", "enc_dropout_rate", "enc_pos_dropout_rate",
              "enc_attn_dropout_rate", "enc_ff_dropout_rate", "dec_dropout_rate")
# the reference's lattice cells a block of rows on the card (fp32: ~1 GiB a
# tensor of the block's joint and loss)
CELLS_PER_BLOCK = 1 << 28


class TransducerFamily(train.U2Family):
    """The U2 family's corpus, batching and attention kernels (the same
    conformer encoder), with the transducer's overrides, layout, operations
    and reference."""

    def overrides(self) -> List[str]:
        cfg, m = self.cell.config, self.m
        return (list(cfg["port"]["train"]) + list(self.mix["port"])
                + [f"model.{k}={m[k]}" for k in MODEL_KEYS]
                + [f"common.seed={self.cell.seed}", "common.trigger=[]",
                   f"task.vocab_size={m['vocab_size']}", f"task.feat_dim={m['input_dim']}",
                   f"task.save_dir={harness.ROOT / 'build' / 'portbench' / 'ckpts'}"])

    def layout(self):
        return ref_rnnt.layout(self.m)

    def summarize(self, records) -> Dict[str, float]:
        m = self.m
        widths = dict(feat_dim=m["input_dim"], enc_layers=m["enc_layers"], d=m["enc_dim"],
                      ff=m["enc_ff_dim"], conv_k=m["conv_kernel"], embed=m["dec_dim"],
                      units=m["dec_units"], dec_layers=m["dec_layers"], joint=m["joint_dim"])
        real = sum(int(x.sum()) for _, x, _ in records)
        work = sum(flops_rnnt.transducer_train_flops(zip(x.tolist(), y.tolist()),
                                                     m["vocab_size"], **widths)
                   for _, x, y in records)
        return {"audio_s": generator.audio_seconds(real, self.mix), "real_frames": real,
                "padded_frames": sum(int(s[0]) * int(s[1]) for s, _, _ in records),
                "flops": work}

    def attn_bound_s(self, batch) -> float:
        """The U2 family's bound; called once a traced micro-step, it also
        prints the micro-step's lattice cells B x T' x (U+1) x V, which the
        program's ``rnnt.lattice_cells`` counter should read."""
        B, T = batch["xs"].shape[:2]
        cells = B * flops.subsampled(T) * (batch["ys"].shape[1] + 1) * self.m["vocab_size"]
        print(f"rnnt: a traced micro-step's lattice holds {cells} cells", file=sys.stderr,
              flush=True)
        return super().attn_bound_s(batch)

    def follow(self, cfg, batches, precision: str) -> Dict:
        cell = self.cell
        model = ref_rnnt.TransducerReference(self.m, Ops(precision))
        seeds = draws.SeedStream(cell.seed)
        dev = cell.device
        cells = CELLS_PER_BLOCK if dev.type == "cuda" else None

        def step(P, k, b):
            b["xs"] = update.spec_augment(b["xs"], b["xlens"], cfg,
                                          draws.step_generator(cell.seed, k, dev))
            return model.loss_and_grads(P, b, draws.Dropouts(cell.seed, k, dev), seeds, cells)

        return update.follow(cell.seed, dev, cfg, batches, self.layout(), step)


def run(cell: harness.Cell) -> harness.Run:
    return train.run_family(cell, TransducerFamily(cell))
