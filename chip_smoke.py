"""Smoke run of liteasr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels (csrc/rel_attention_fwd.cu and
   csrc/rel_attention_bwd.cu, one nvcc each, in parallel, sm_90a) and
   prints ptxas's registers, shared memory and spills per kernel and the
   libraries' tensor-core (HGMMA, HMMA) and cp.async (LDGSTS) instruction
   counts from cuobjdump -sass;
2. K1: holds the forward kernel against its plain PyTorch version at the
   three attention shapes of the decode slice, in fp32 (tol 1e-4, TF32
   off) and bf16 (tol 2e-2), and times both with CUDA events, beside the
   call's bound (bytes over 3.35 TB/s or operations over the type's peak,
   whichever is larger) and, for the two decoder shapes, one
   scaled_dot_product_attention call with the same mask (a yardstick the
   port never calls);
3. K1' and K2: holds the training forward (lse, dropout 0.1) and the
   backward against their plain versions at the training shape (BH=128,
   T'=199, D=64, a kv_len=0 row), fp32 (tol 1e-4 forward, 1e-3 grads) and
   bf16 (2e-2, 5e-2), and times kernel and plain forward+backward beside
   their bounds; then K1' and K2 in bf16 at a long utterance (BH=32,
   T'=1499), checked and timed;
4. decodes a generated Kaldi corpus (32 utterances of 1000-1600 frames x 80
   fbank, 5000-token vocab) with the full-width U2 (12 conformer layers,
   256-d, 6 decoder layers, bf16 compute, random weights from a seed)
   through ``infer_dataset`` in attention_rescore mode (beam 10, CTC weight
   0.5, 16 utterances per batch): 24 K1 launches per batch;
5. runs 2 utterances through the same weights in fp32 on the GPU (kernel)
   and on the CPU (plain path) and bounds the encoder and CTC log-prob
   difference by 1e-3;
6. trains the full-width U2 (my_U2, bf16, dropout 0.1, my_hybrid_ctc,
   my_noam, clip 5, accum 2, no SpecAugment) through
   ``liteasr_tpu_torch.train.main`` on a generated corpus (80 train and 16
   valid utterances of 400-800 frames, 24-48 tokens, batch 32) for 2 epochs:
   12 K1' and 12 K2 launches per micro-batch, finite losses, moved
   parameters, ``valid loss:`` lines, and a ``model.ep.2.pt`` that
   ``infer`` decodes (24 K1 launches per batch);
7. times the train micro-step at bench.py's operating point (B=32, T=800,
   U=48): 5 warm-up steps, then the median of 5 repetitions of 10, with
   utt/s and MFU against the H100's dense bf16 peak (informational), and
   the device-busy share of 10 more micro-steps traced with device
   activity only;
8. one fp32 train step (TF32 off, dropout 0, 2 encoder and 1 decoder
   layer at full width) on the GPU (kernels) and the CPU (plain path): the
   loss and every gradient agree within 1e-3 of the leaf's own max (the
   depthwise-conv and attention key biases, whose gradient is 0 in exact
   arithmetic, within 1e-3 of the largest gradient).

The rest of the U2 recipe, at the same full width:

a. front end: a generated raw-wave corpus (``kaldi_io.write_wav`` and
   wav.scp; 80 train and 16 valid utterances of 4-8 s at 16 kHz, 398-798
   fbank frames, 24-48 tokens); ``log_mel_fbank`` of one batch of 32 on the
   card against the CPU (fp32, within 2e-2, the two empty mel filters
   which must be 0); device
   SpecAugment with the recipe's settings: padding untouched outside the
   frequency masks, the draws in their ranges, one result per (seed, step),
   the card against the CPU at the same draws within 1e-5; both timed;
b. the recipe trained through ``train.main`` from the raw waves
   (``dataset.fbank=true``, device SpecAugment, ``model.remat=true``,
   dropout 0.1, my_hybrid_ctc, my_noam, clip 5, accum 2, batch 32): 1
   epoch, then ``common.resume=auto`` to 3 epochs: ``iter``/``epoch``
   continue from the ``.meta``, no ``valid``/``save_model`` event repeats,
   3 ``valid loss:`` lines, ``model.ep.{1,2,3}.pt``, finite losses, 24 K1'
   (12 more in the recompute) and 12 K2 launches per micro-batch;
c. ``infer.infer`` of that run with ``model_avg=true avg_num=2`` and the
   run dir as the N-best policy, ``mode=attention``, beam 10, on the
   raw-wave valid set: the averaged epochs are the two best of
   ``parse_valid_history``, 12 K1 launches per batch (the encoder; the
   cached beam's step attention is plain);
d. attention-mode decoding timed on the corpus of 4, beside 4's
   attention_rescore figures;
e. the attention beam of 2 utterances in fp32 on the card and on the CPU
   (peaked decoder posteriors): the same hypotheses, best scores within
   1e-3;
f. remat at bench.py's point: one fp32 step (dropout 0.1, same seed and
   weights) with remat on and off, every gradient within the rule of 8;
   then the bf16 micro-step's time and peak memory with remat off and on.

The hard-corpus recipe of ``liteasr_tpu_torch/tools`` (the port of the
repo's tools/ recipes), my_U2 at full width:

hc. ``make_synth_corpus --hard`` at seed 0 cut to 1,024 train, 64 valid and
   64 test utterances (the BPE-unit corpus, vocab 250 with blank and
   sos/eos); ``run_hard u2`` (tools/run_hard.sh's overrides: bf16, accum 2,
   my_noam) for 3 epochs with a warm-up over the run's 48 steps
   (``optimizer.warmup=48 optimizer.factor=0.2``): 12 K1' + 12 K2 per
   micro-batch, 24 K1 per valid batch, finite valid losses in the results
   rows equal to train.log's (``summarize_run``), the last at most 0.95 of
   the first; ``eval_hard u2`` at epoch 3 over the 3 checkpoints: the
   averaged attention_rescore and ctc_greedy and the last checkpoint's
   rescore (24, 12 and 24 K1 per batch), three ``index\tref\thyp`` dumps
   and three ``score_ci`` rows (the rate with its bootstrap CI, rescore vs
   greedy and averaged vs last, paired).

The transducer (the my_transducer preset at full width: 4 rel-pos
transformer layers, 256-d, 4 heads, FF 2048, relu; a 2 x 2048 LSTM over
256-d embeddings; joint 768; vocab 5000; bf16 compute over fp32 params):

g. trained through ``train.main`` (my_rnnt, my_noam, dropout 0.1, clip 5,
   accum 2, no SpecAugment) on the corpus of 6 for 2 epochs: 4 K1' and 4 K2
   launches per micro-batch, 4 K1 per valid batch, one RNN-T DP forward
   launch a micro-batch and a valid batch and one backward a micro-batch,
   finite losses, moved
   parameters (every LSTM leaf among them), ``valid loss:`` lines and a
   ``model.ep.2.pt`` that ``infer.infer`` decodes greedily and with the beam
   (4 K1 launches per batch each);
h. the micro-step at bench.py's point (B=32, T=800, U=48): median of 5
   repetitions of 4, utt/s and peak memory; the joint's output GEMM, the
   lattice's fp32 lse and gathers, and the RNN-T DP (its two kernels) each
   timed alone (forward and backward) at those shapes, one DP launch each
   way a micro-step; the DP's kernels and the plain loop over T'=199 in
   fp32 against the loop in fp64 on the phase's batch (loss and both
   gradients, to the limits of ``tests/test_torch_rnnt_gpu.py``: the
   kernels' gradients relative to each), one launch each way, and each
   side's forward and backward timed alone beside the kernels' bound;
i. the corpus of 4 decoded through ``infer_dataset`` with random weights,
   greedy (3 symbols per frame) and the beam (K=10, E=5): s/batch, utt/s,
   RTF, with and without the host's scoring, 4 K1 launches per batch;
j. fp32 (TF32 off): one train step (2 encoder and 1 LSTM layer at full
   width, dropout 0) on the card against the CPU's in fp64 under the rule
   of 8, and the bf16 model's loss and lattice against it (measured only);
   greedy and the beam of 2 cut utterances with lin_jnt scaled by 8 on the
   card and the CPU: identical hypotheses, beam scores within 1e-3.

Streaming U2 (the streaming model: my_U2 with ``model.enc_arch=transformer``,
12 rel-pos transformer layers, 256-d, 4 heads, FF 2048, swish, 6 decoder
layers, vocab 5000, bf16 compute over fp32 params, random weights from the
seed):

k. kernels: K1' and K2 with the chunk width 1, 5, 16, 25 and none at the
   training shape (BH=128, T'=199, D=64, a kv_len=0 row, dropout 0.1), fp32
   (1e-4 forward, 1e-3 grads) and bf16 (2e-2, 5e-2) against the plain
   versions, each bf16 call timed beside its bound over the scores the
   chunk leaves live; K1 with chunk 16 at the encoder decode shape (BH=64,
   T'=399) the same way;
l. ``model.dynamic_chunk=true`` trained through ``train.main`` on the corpus
   of 6 for 2 epochs (my_hybrid_ctc, my_noam, dropout 0.1, clip 5, accum 2;
   ``common.log_level=DEBUG`` logs each drawn width): 12 K1' and 12 K2
   launches per micro-batch, a width per micro-batch with both full-context
   and chunked draws, finite losses, moved parameters, ``valid loss:``
   lines; then ``model.static_chunk_size=16`` for 1 epoch (its valid pass
   through K1 with chunk 16); ``infer.infer`` of the dynamic checkpoint in
   ``streaming_ctc_greedy`` and ``streaming_ctc_prefix_beam_search`` and of
   the static one in ``streaming_ctc_greedy``; the micro-step at bench.py's
   point with chunk 16 and with full context: utt/s and peak memory;
m. decoding: the corpus of 4 through ``infer_dataset`` with the random
   dynamic-chunk model in ``streaming_ctc_greedy`` (chunk_sub 16 and 8) and
   ``streaming_ctc_prefix_beam_search`` (beam 10): s/batch, utt/s, RTF, with
   and without the host's scoring; the streaming step as
   ``tools/bench_streaming.py`` times it (B=8, chunk_sub 16, 24 chunks,
   ``static_chunk_size=16``, a sync per chunk): median and p95 per-chunk
   latency and the streaming RTF; the static model decoded offline in
   ``ctc_greedy`` (12 K1 launches per batch, each with chunk 16);
n. parity in fp32 (TF32 off): on the card the streaming runtime's hidden
   states equal the offline chunked encoder's on the valid frames (rtol
   1e-4, atol 1e-5) with identical hypotheses; card and CPU give identical
   streaming hypotheses (greedy and prefix beam) on 2 cut utterances; one
   dynamic-chunk train step at chunk 8 (2 + 1 layers at full width,
   dropout 0) on the card against the CPU's in fp64 under the rule of 8;
   the native host library is loaded and its Levenshtein equals the
   pure-Python one on m's decoded pairs.

The Paraformer (ParaformerConfig's defaults at full width: 12 rel-pos
conformer layers, 256-d, 4 heads, FF 2048, swish; the CIF predictor; 6
parallel decoder layers; sample_ratio 0.75, glance_at_eval; vocab 5000;
bf16 compute over fp32 params):

o. K1 at the parallel decoder's shapes, no rel-pos term: pass 1 of a
   training step (self-attention without a mask, BH=128 x 48 x 48; source
   attention with kv_lens, 128 x 48 x 199) and a decoded batch (64 x 399 x
   399 without a mask and with kv_lens), fp32 (1e-4, TF32 off) and bf16
   (2e-2) against the plain version, each bf16 call timed beside its bound
   and one SDPA call with the same mask;
p. trained through ``train.main`` (paraformer_loss, my_noam, dropout 0.1,
   clip 5, accum 2, no SpecAugment) on the corpus of 6 for 2 epochs: 12 K1'
   + 12 K2 + 12 K1 (pass 1) launches per micro-batch and 36 K1 per valid
   batch, finite loss_ce and loss_mae, moved parameters (every predictor
   leaf among them), ``valid loss:`` lines and a ``model.ep.2.pt`` that
   ``infer.infer`` decodes (24 K1 launches per batch);
q. the micro-step at bench.py's point (B=32, T=800, U=48): median of 5
   repetitions of 4, utt/s and peak memory; cif_dense and cif_scan each
   alone, forward and backward, at that CIF shape and at the decode shape
   (B=16, U=T'=399);
r. the corpus of 4 decoded through ``infer_dataset`` with random weights
   (CIF + argmax): s/batch, utt/s, RTF, with and without the host's
   scoring, 24 K1 launches per batch;
s. parity in fp32 (TF32 off), the glance noise handed to both sides: one
   train step (2 encoder and 1 decoder layer at full width, dropout 0) on
   the card against the CPU's in fp64 under the rule of 8, its CIF fire
   counts identical; 2 cut utterances decoded on the card and the CPU
   (linear_out x8): identical fire counts, hypotheses and ulens (a
   disagreement prints the frames and their csum/beta).

wav2vec 2.0 pretraining (Wav2Vec2Config's defaults at full width: the
7-conv /320 extractor, 12 transformer layers, 768-d, 12 heads, FF 3072,
relu, conv positional embedding k=128 / 16 groups, 2 x 320 Gumbel codes,
100 negatives, mask_prob 0.65 span 10; bf16 compute over fp32 params;
random weights from the seed):

t. K1 at the encoder's validation shapes without a mask (BH = 24 rows x 12
   heads, T = 174: the operating point's batch; 8 x 12, T = 774: the
   250,000-sample crop's), fp32 (1e-4, TF32 off) and bf16 (2e-2) against
   the plain version, each bf16 call timed beside its bound and one SDPA
   call;
u. ``task=pretrain`` trained through ``train.main`` (tools/run_pretrain.sh's
   recipe: diversity 1.0, Adam lr 2e-4, clip 5, accum 1) on a's raw-wave
   corpus for 2 epochs: no K1'/K2 launch in a micro-batch, 12 K1 per valid
   batch, finite losses, every parameter moved (quantizer.vars and
   mask_emb among them), ``valid loss: ... | accuracy: ... | code_ppl:``
   lines and a ``model.ep.2.pt``; then 1 epoch and a ``common.resume=auto``
   continuation whose epoch-2 valid line equals the uninterrupted run's
   (both in torch's deterministic mode);
v. the micro-step at the operating point (23 utterances + 1 dummy row x
   56,000 samples, F = 174): median of 5 repetitions of 4, utt/s, peak
   memory and MFU from the step's operations; the device-busy share and
   the top device ops of 4 steps traced with device activity only; the
   conv extractor, the conv positional embedding and the negatives' gather
   with compute_logits each alone, forward and backward; the host's draws;
w. parity in fp32 (TF32 off): 2 encoder layers at full width with the
   full conv stack, dropout 0, on the card against the CPU in fp64 at the
   same weights and draws: the eval -inf count (printed first), loss,
   accuracy and code_ppl; one train step under the train-parity rule.

Data parallelism on the one card (NCCL refuses two ranks on one device, so
the group has one rank; tests/test_torch_dp*.py hold 2 ranks to 1 on the
CPU over gloo):

x. my_U2 at full width trained through ``train.main`` with
   ``distributed.coordinator_address=127.0.0.1:<free port>
   distributed.num_processes=1 distributed.process_id=0`` on 6's corpus for
   1 epoch: the backend is NCCL, 12 K1' and 12 K2 launches per micro-batch
   (as 6), the collectives counted by kind (the flat gradient once per
   applied step, BatchNorm's forward and backward in each of the 12 layers
   per micro-batch, the utterance count per criterion call, the valid
   scalars, the generator states at save), finite losses, the valid line's
   aux keys; its checkpoint decoded through ``infer.infer`` inside a group
   (24 K1 launches per batch) and without one: the same error count and
   decoded pairs; then phase 8's fp32 step (TF32 off, dropout 0, 2 + 1
   layers at full width) inside the group and twice without it: the loss,
   every gradient leaf (as the optimizer takes it, after its all-reduce)
   and the BatchNorm running statistics within 1e-5 of the leaf's max (the
   leaves whose gradient is 0 in exact arithmetic: of the largest
   gradient), beside the two ungrouped runs' difference (K2's fp32
   atomics);
y. the micro-step at bench.py's point in turns without a group and inside
   a one-rank group started afresh each turn (5 x 10 micro-steps each way),
   the medians against each other and 7's, utt/s, peak memory, the
   collectives per micro-step, the host's time inside them, the NCCL
   kernels and their device time in a trace of 10 micro-steps (device
   activity only), and one flat all-reduce of the parameters alone in the
   one-rank group, a call that moves no bytes (the host's cost of the call,
   not the all-reduce's cost on 2+ cards, which one card cannot show).

Tensor and sequence parallelism (U2), on the one card: the kernels at their
offsets, then 2 ranks that share the card in a gloo group over CUDA
tensors, which each rank starts itself and the port joins (NCCL refuses
two ranks on one device); every kernel runs on the card, only the
collectives go through the host:

z1. K1' and K2 in bf16 at the training shape on the shards tp = 2 gives
   (BH = 64 of 128, head0 0 or 2) and sp = 2 gives (queries 0..100 and
   100..199 of T' = 199 with the next block's first q_v row, also under
   chunk 16), dropout 0.1, a kv_len = 0 row: against the plain versions at
   the same offsets (3's tolerances), against the rows and heads of the
   whole kernel call within 1e-5 (out, lse, K1, the five gradients and the
   halo's dQ_v row: the same arithmetic); the keep mask read off
   the kernel (zero scores, V the unit vectors of 64 keys at a time)
   bit-equal to the whole call's slice and to dropout_keep_global's; K1 at
   the same offsets (validation's call) against the plain version; each
   call timed beside its bound and the plain version; then K1 at the
   Paraformer's pass-1 calls under tp = 2 (o's bench-point self 48 x 48 and
   source 48 x 199 attention, heads 0..2 and 2..4 of 4: BH = 64 of 128)
   against the plain version (o's tolerance) and the whole call's heads
   (1e-5), timed beside its bound, the plain version and one SDPA call;
   then K1 at wav2vec 2.0's two validation shapes (t's) under tp = 2
   (heads 0..6 and 6..12 of 12) and sp = 2 (the two query blocks over all
   the keys), the same way;
z2. for tp = 2 and for sp = 2 in turn: my_U2 at full width through
   ``train.main`` in the 2 processes on 6's corpus for 1 epoch with the
   valid, save_model and inference (ctc_greedy) triggers: 12 K1' + 12 K2
   launches per micro-batch per rank at the shard's shapes (the rank's
   heads, or its block of T' with the halo row), finite losses, the
   checkpoint in the one-process layout (the same keys and shapes),
   decoded in one process to the error count the run's trigger logged;
z3. 8's fp32 step (TF32 off, dropout 0, 2 + 1 layers at full width) in the
   layout against the one-process step: the loss within 1e-5, every
   gathered gradient leaf and the BatchNorm statistics within 3e-4 of the
   leaf's max (the layouts reorder sums, and the step resolves no better
   in fp32), beside two one-process runs' own difference and the
   one-process step's with its input moved by 1-2 ulps; then the same
   step with a planted layout fault (BatchNorm counting one frame too many
   a row; under sp also one halo frame of the depthwise conv dropped),
   which the bound must catch;
z4. the bf16 micro-step at bench.py's point in the layout: ms and peak
   memory per rank, informational (the two ranks share the card);
z5-z7. the same for the transducer in the same 2 processes (after U2's):
   my_transducer at full width through ``train.main`` (4 K1' + 4 K2 per
   micro-batch a rank at the shard's shapes; one RNN-T DP forward launch a
   micro-batch and a valid batch, one backward a micro-batch, and one each
   way a bf16 micro-step; transducer_greedy decoding),
   its fp32 step (2 encoder + 1 LSTM layer) with a planted fault (under tp
   the last encoder layer's attention output all-reduce dropped, under sp
   the RNN-T utterance count reduced over dp x sp), its bf16 micro-step
   (the lattice of the rank's rows: B/sp, or all B under tp);
z8-z10. the same for the Paraformer: build_para_model's widths through
   ``train.main`` (12 K1' + 12 K2 and pass 1's 12 K1 per micro-batch a
   rank, pass 1 at the rank's heads of its rows; loss_ce and loss_mae on
   the valid lines), its fp32 step (2 + 1 layers, glancing) with a planted
   fault (under tp the parallel decoder's source-attention output
   all-reduce dropped, under sp the token and utterance counts reduced
   over dp x sp), its bf16 micro-step;
z11-z13. the same for wav2vec 2.0 (Wav2Vec2Config's defaults): pretraining
   through ``train.main`` on a's waves for 1 epoch with validation (12 K1
   a valid batch a rank at the shard's shapes: the rank's 6 heads, or its
   block of the frames over all of them; no K1' or K2), finite losses, the
   skipped updates printed, the checkpoint in the one-process layout; the
   fp32 step (2 encoder layers at full width, dropout 0, 4 utterances of
   32,000-48,000 samples with no dummy row, so that its update is applied)
   against one process within 3e-4 of each leaf's max, or twice the step's
   fp32 resolution where that exceeds 3e-4, beside that resolution, with a
   planted fault it must catch (under tp the diversity term divided by the
   process count, under sp the positional conv's halo zeroed); the bf16
   micro-step at v's point: ms and peak memory per rank.

Export, in a process of its own started after the kernel build, so that
its host-bound export and load overlap the phases above:

e1. my_U2 at full width (bf16, random weights) exported through
   ``export.export_decode`` in attention_rescore mode at the JAX export
   CLI's bucket (16 x 1600 x 80), traced on the card, saved to bytes and
   loaded: 24 ``liteasr::rel_attention_fwd`` nodes; once the other phases
   are done, its run on the card launches K1 24 times and gives the live
   pipeline's tokens and lengths exactly; the export's and the load's
   seconds, the bytes, and the program's time a batch beside the live
   pipeline's.

Every phase prints its seconds, and the run a ``phase seconds`` line before
the kernels line. Every failure raises, so the exit code is not 0. The last
line is the JSON device record; the line before it lists the kernels (for
rel_attention_fwd, ``ms``/``plain_ms`` are K1 per decoded batch, the
``lse_*`` keys K1' per training call, the ``chunk*`` keys the chunked calls
of k, the ``paraformer_*`` keys o's calls and the ``wav2vec2_*`` keys t's,
the ``dp_*`` keys x's and y's, the ``shard_*`` keys z1's calls and the
``tp_sp_*`` keys z2, z5 and z8's launches and z4, z7 and z10's steps, the
``paraformer_tp_*`` keys z1's pass-1 calls, the ``wav2vec2_shard_*`` keys
z1's wav2vec 2.0 calls, the ``export_*`` keys e1, the ``hard_corpus_*`` keys
hc's; ``launches`` sum the main paths 4, 6, b, c, d, hc, g, i, l, m, p, r, u,
x, z2, z5, z8, z11 and e1; for rnnt_dp, the RNN-T DP's kernels, the main
paths g, h, z5 and z7, and ``ms``/``plain_ms`` its forward at h's batch).

    python3 chip_smoke.py --profile-train

runs only a host+device torch.profiler window over the train micro-step
of 7 and prints the top kernels by device time.

    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --dp-only
    python3 chip_smoke.py --tp-sp-only
    python3 chip_smoke.py --export-only
    python3 chip_smoke.py --baseline DIR
    python3 chip_smoke.py --hc-only
    python3 chip_smoke.py --convergence [--keep DIR] [--deadline S]

stop after steps 1-3, k, o, t and z1; or after them run only 7, x and y;
or only z2-z13; or only e1; or after step 1 time every bf16 kernel call
of the main paths against the checkout in DIR (another commit unpacked
with git archive), in the order DIR, this tree, this tree, DIR;
``--hc-only`` runs phase hc after the build; ``--convergence`` (not part of
the default run) renders the full hard corpus (20,000 / 500 / 500
utterances, seed 0) under ``exp/synth_hard`` unless it is there, trains
``run_hard u2`` into ``exp/hard_u2_run`` (which must hold no run yet) in
legs ending at epochs 5 and 30 (the second resumes the first,
``common.resume=auto``), starting no epoch that could end the eval after
``--deadline`` seconds of the script (3,540), prints the per-epoch valid
rows and each leg's seconds and launches an epoch, runs ``eval_hard u2`` at
the last saved epoch over the 5 last checkpoints, decodes the last
checkpoint's attention rescore again at the training's padding of 128 and
at 512 through K1's plain version, copies the run's logs, rows and dumps to
``--keep``'s directory and fails unless epoch 30 was reached with a valid
loss of at most 3.47, the last checkpoint's attention rescore at most 8.8%
and the averaged rescore beating the averaged CTC greedy with the paired
95% CI of the difference below 0.
"""

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
VOCAB = 5000
FEAT = 80
N_UTT, MIN_T, MAX_T = 32, 1000, 1600
BATCH, BEAM, CTC_WEIGHT = 16, 10, 0.5
PAD_TIME = 64  # the longest batch pads to T=1600 frames, T'=399
ENC_LAYERS, DEC_LAYERS, HEADS, DIM = 12, 6, 4, 256
FRAME_S = 0.01  # 10 ms fbank hop
PARITY_TOL = 1e-3
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# training slice: 800 frames -> T' = 199, 4 heads of 64
TRAIN_BH, TRAIN_T, TRAIN_D, TRAIN_RATE, TRAIN_SEED = 128, 199, 64, 0.1, 1234
N_TRAIN, N_VALID, TRAIN_MIN_T, TRAIN_MAX_T = 80, 16, 400, 800
TRAIN_BATCH, TRAIN_EPOCHS, ACCUM = 32, 2, 2
H100_BF16_PEAK = 989e12  # dense, SXM, at 700 W (NVIDIA data sheet)
H100_FP32_PEAK = 67e12  # outside the tensor cores
H100_HBM_RATE = 3.35e12  # bytes/s
# K1'/K2 at a long utterance (6000 frames -> T' = 1499), timed only
LONG_BH, LONG_T = 32, 1499
# the recipe on raw waves (phases a-c)
WAVE_RATE, N_WAVE_TRAIN, N_WAVE_VALID, WAVE_MIN_S, WAVE_MAX_S = 16000, 80, 16, 4.0, 8.0
RECIPE_EPOCHS = 3
# the hard-corpus recipe (hc; liteasr_tpu_torch/tools): make_synth_corpus
# --hard at seed 0 cut to (train, valid, test) utterances, run_hard u2
# for HC_EPOCHS, eval_hard u2 at its last checkpoint over HC_AVG; my_noam's
# 25,000 warm-up steps leave a 48-step run at a rate of ~3e-7, so the
# warm-up spans the run and peaks at 0.2 * 256^-0.5 * 48^-0.5 = 1.8e-3
HC_UTTS, HC_EPOCHS, HC_AVG = (1024, 64, 64), 3, 3
HC_NOAM = ["optimizer.warmup=48", "optimizer.factor=0.2"]
HC_MARGIN = 0.95  # the last epoch's valid loss at most this share of the first's
# --convergence: run_hard u2 on the full hard corpus (20,000 / 500 / 500
# utterances, seed 0) in legs ending at these epochs, each resuming the
# last (common.resume=auto), then eval_hard u2 at the last with avg_num 5;
# the bounds, fixed before the first run, are 1.5x the JAX package's record
# at checkpoint 30 (BENCHMARKS.md:196-213: valid loss 2.31, attention
# rescore of the last checkpoint 5.87%), and the averaged rescore must beat
# the averaged CTC greedy with the paired 95% CI of the difference below 0
CONVERGENCE_LEGS, CONVERGENCE_AVG = (5, 30), 5
CONVERGENCE_BOUNDS = {"valid_loss": 3.47, "last_rescore": 0.088}
# the script's wall clock by which the eval ends (``--deadline S`` sets
# another), the seconds kept for the eval (its 3 decodes of the 500 test
# utterances took ~25 s with the checkpoint loads; the 2 decodes beside them
# take as long) and for the epoch in flight (96-171 s measured): no epoch
# starts after the deadline less both (run_hard's timeout_s)
CONVERGENCE_DEADLINE_S, CONVERGENCE_EVAL_S, CONVERGENCE_EPOCH_S = 3540, 120, 180
# the training's padding, at which the last checkpoint is decoded beside
# eval_hard's 512 (the padded length moves the encoder: ROADMAP section 3)
TRAIN_PAD_TIME = 128
# card (cuFFT) against CPU (pocketfft), after CMVN: preemphasis leaves the
# lowest mel bins ~1e-3 of a frame's power, and in frames where that power
# is near 0 the log amplifies the two FFTs' rounding (6.6e-3 seen at this
# seed, NVIDIA H100 80GB HBM3, 700 W)
FBANK_TOL = 2e-2
SPEC_AUG = dict(time_warp=5, freq_mask=30, freq_mask_times=2, time_mask=40,
                time_mask_times=2)  # config.yaml's postprocess.spec_aug
SPEC_AUG_TOL = 1e-5
BEAM_SCORE_TOL = 1e-3
# the my_transducer preset: 4 transformer layers (DIM, HEADS, FF 2048,
# rel-pos, relu), a 2 x 2048 LSTM over DIM-d embeddings, joint 768
TD_ENC_LAYERS, TD_LSTM_LAYERS, TD_UNITS, TD_JOINT = 4, 2, 2048, 768
# streaming (k-n): the chunk widths of k, the static model's width, the
# streaming step of tools/bench_streaming.py (B, chunk_sub, chunks)
CHUNKS, STATIC_CHUNK = (1, 5, 16, 25), 16
STREAM_B, STREAM_CHUNK_SUB, STREAM_N_CHUNKS = 8, 16, 24
STREAM_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_streaming_decode.py:63-64
# wav2vec 2.0 (t-w): Wav2Vec2Config's defaults; K1's validation shapes
# (BH, T) at D = 64: the operating point's 24 rows x 174 frames and the
# 250,000-sample crop's 8 rows x 774; the operating point of
# tools/run_pretrain.sh (23 utts of the corpus's 3.75 s mean + 1 dummy row)
W2V_LAYERS, W2V_HEADS, W2V_DIM = 12, 12, 768
W2V_SHAPES = {"step_batch": (24 * 12, 174), "long_crop": (8 * 12, 774)}
W2V_STEP_ROWS, W2V_STEP_SAMPLES, W2V_EPOCHS = 24, 56000, 2
REPO = os.path.dirname(os.path.abspath(__file__))
START = time.time()


def log(*args):
    print(*args, flush=True)


PHASE_SECONDS = {}


@contextlib.contextmanager
def phase(label):
    """Log the seconds the phase ``label`` takes (also when it fails)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[label] = time.perf_counter() - t0
        log(f"phase {label}: {PHASE_SECONDS[label]:.1f} s")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3, inner: int = 10) -> float:
    """Time of one call from CUDA events: the median over ``reps`` of the
    mean of ``inner`` back-to-back calls (so the host's launch latency,
    ctypes and allocation included, hides behind the device's work unless
    it is longer than the call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def reset_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_attention.lse_launches = 0
    fa.flash_attention.chunk_launches = 0
    fa.flash_attention.lse_chunk_launches = 0
    fa.flash_rel_attention_bwd.launches = 0
    fa.flash_rel_attention_bwd.chunk_launches = 0


def counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention.lse_launches,
            fa.flash_rel_attention_bwd.launches)


def chunk_counts(fa):
    """(K1, K1', K2) launches that ran with a chunk width, as the wrappers
    count them."""
    return (fa.flash_attention.chunk_launches - fa.flash_attention.lse_chunk_launches,
            fa.flash_attention.lse_chunk_launches, fa.flash_rel_attention_bwd.chunk_launches)


def reset_dp_counts():
    """Zero the RNN-T DP kernels' launch counts (``ops.rnnt.lattice_nll``)."""
    from liteasr_tpu_torch.ops import rnnt

    rnnt.lattice_nll.launches = 0
    rnnt.lattice_nll.bwd_launches = 0


def dp_counts():
    """(forward, backward) launches of the RNN-T DP kernels."""
    from liteasr_tpu_torch.ops import rnnt

    return rnnt.lattice_nll.launches, rnnt.lattice_nll.bwd_launches


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, nbytes_: float, dtype):
    """(bound_ms, bound_by): the larger of the work at the card's peak rate
    for the operands' type and the bytes at its memory rate."""
    peak = H100_BF16_PEAK if dtype == torch.bfloat16 else H100_FP32_PEAK
    t_ops, t_bytes = flops / peak, nbytes_ / H100_HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def live_keys(bh: int, tq: int, tk: int, kv_lens, chunk: int = 0,
              q0: int = 0) -> torch.Tensor:
    """(BH, Tq) keys each query needs: those below kv_len (capped at Tk) and,
    under a chunk width, below the end of the query's chunk ((t // chunk +
    1) chunk, t = q0 + the local query for a block of the queries); all Tk
    for a row with no key (kv_len 0, whose output is the mean of V)."""
    kv = (torch.full((bh,), tk, dtype=torch.int64) if kv_lens is None
          else kv_lens.cpu().long().clamp(max=tk))
    end = kv[:, None].expand(bh, tq)
    if chunk > 0:
        t = q0 + torch.arange(tq)
        end = torch.minimum(end, ((t // chunk + 1) * chunk)[None, :])
    return torch.where(kv[:, None] > 0, end, tk)


def fwd_bound(q, k, v, mask=None, kv_lens=None, rel_qv=None, rel_p=None,
              lse=False, chunk=0, q0=0):
    """Bound of one K1/K1' call from its shapes: Q K^T, P V and (with the
    rel-pos term) Q_v P^T over the scores the data leaves live; each input
    read once and each output written once (K and V only up to the row's
    last live key)."""
    bh, tq, d = q.shape
    live = live_keys(bh, tq, k.shape[1], kv_lens, chunk, q0)
    keys = live.max(dim=1).values.sum().item()
    flops = (3 if rel_qv is not None else 2) * 2.0 * live.sum().item() * d
    kv_bytes = 2 * keys * d * k.element_size()
    out = bh * tq * d * q.element_size() + (4 * bh * tq if lse else 0)
    return bound(flops, nbytes(q, rel_qv, rel_p, mask, kv_lens) + kv_bytes + out,
                 q.dtype)


def bwd_bound(q_u, qv, k, v, p, kv_lens, out, lse, dout, chunk=0, q0=0):
    """Bound of one K2 call: eight products over the live (query, key)
    scores x D, the inputs read once, the five fp32 gradients written once."""
    bh, t, d = q_u.shape
    flops = 8 * 2.0 * live_keys(bh, t, k.shape[1], kv_lens, chunk, q0).sum().item() * d
    grads = 4 * (q_u.numel() + qv.numel() + k.numel() + v.numel() + p.numel())
    return bound(flops, nbytes(q_u, qv, k, v, p, kv_lens, out, lse, dout) + grads,
                 q_u.dtype)


def library_call(args, scale):
    """One torch.nn.functional.scaled_dot_product_attention call computing
    a decoder shape's function (no rel-pos term, no dropout): the bool mask
    (True = masked) broadcast over the heads, kv_lens as a key-padding
    mask, or no mask. Returns the call; the masks are built outside it. A yardstick
    only: the port never calls it."""
    import torch.nn.functional as F

    q, k, v = args["q"], args["k"], args["v"]
    bh, tq, d = q.shape
    scale = float(scale)
    if "mask" in args:
        m = args["mask"].shape[0]
        keep = ~args["mask"][:, None]  # (M, 1, Tq, Tk), True = attend
        shp = (m, bh // m)
    elif "kv_lens" in args:
        j = torch.arange(k.shape[1], device=q.device)
        keep = (j[None, :] < args["kv_lens"][:, None])[:, None, None, :]
        shp = (bh, 1)
    else:  # no mask
        keep, shp = None, (bh, 1)
    q4, k4, v4 = (x.view(*shp, x.shape[1], d) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep,
                                                  scale=scale)


def within(got, ref, tol) -> bool:
    return bool(((got.float() - ref.float()).abs()
                 <= tol + tol * ref.float().abs()).all())


def slice_shapes(gen, dev, dtype):
    """The three attention calls of one decode batch (B=16, T'=399, K=10):
    encoder rel-pos self-attention, decoder self-attention (pad | causal
    mask over the 160 hypotheses) and decoder source attention."""
    B, H, Dk, T = BATCH, HEADS, DIM // HEADS, 399
    L = T + 1
    BK = B * BEAM

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    enc_lens = torch.randint(1, T + 1, (B,), generator=gen)
    enc_lens[0], enc_lens[1] = T, 1
    hyp_lens = torch.randint(0, T + 1, (BK,), generator=gen)
    self_mask = ((torch.arange(L)[None, None, :] >= (hyp_lens + 1)[:, None, None])
                 | torch.triu(torch.ones(L, L, dtype=torch.bool), 1)[None])
    src_lens = enc_lens.repeat_interleave(BEAM)
    return {
        "encoder_rel": dict(
            q=rnd(B * H, T, Dk), k=rnd(B * H, T, Dk), v=rnd(B * H, T, Dk),
            rel_qv=rnd(B * H, T, Dk), rel_p=rnd(H, T, Dk),
            kv_lens=enc_lens.repeat_interleave(H).to(dev, torch.int32)),
        "decoder_self_mask": dict(
            q=rnd(BK * H, L, Dk), k=rnd(BK * H, L, Dk), v=rnd(BK * H, L, Dk),
            mask=self_mask.to(dev)),
        "decoder_src_kv_lens": dict(
            q=rnd(BK * H, L, Dk), k=rnd(BK * H, T, Dk), v=rnd(BK * H, T, Dk),
            kv_lens=src_lens.repeat_interleave(H).to(dev, torch.int32)),
    }


def check_kernel(fa, dev, name):
    """K1 vs plain at the decode shapes. Returns the bf16 error and the
    per-decode-batch times."""
    gen = torch.Generator().manual_seed(SEED)
    per_batch = {"encoder_rel": ENC_LAYERS, "decoder_self_mask": DEC_LAYERS,
                 "decoder_src_kv_lens": DEC_LAYERS}
    report = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, args in slice_shapes(gen, dev, dtype).items():
            scale = args["q"].shape[-1] ** -0.5
            out = fa.flash_attention(scale=scale, **args)
            ref = fa.flash_attention_plain(scale=scale, **args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = KERNEL_TOL[dtype]
            if not within(out, ref, tol):
                raise RuntimeError(f"K1 {shape} {dtype}: max abs err {err} "
                                   f"exceeds atol=rtol={tol}")
            ms = cuda_time_ms(lambda: fa.flash_attention(scale=scale, **args))
            plain_ms = cuda_time_ms(
                lambda: fa.flash_attention_plain(scale=scale, **args))
            bound_ms, bound_by = fwd_bound(**args)
            lib = ""
            if "rel_qv" not in args:
                lib_ms = cuda_time_ms(library_call(args, scale))
                lib = f", library (SDPA) {lib_ms:.4f} ms"
                if dtype == torch.bfloat16:
                    report[f"{shape}_library_ms"] = lib_ms
            log(f"K1 {shape} {str(dtype)[6:]} shape={tuple(args['q'].shape)}x"
                f"{args['k'].shape[1]}: max_abs_err={err:.3g} (tol {tol}) "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
                f"{bound_ms:.4f} ms ({bound_by}) = {bound_ms / ms:.2%} of it [{name}]")
            if dtype == torch.bfloat16:
                n = per_batch[shape]
                report["max_abs_err"] = max(report["max_abs_err"], err)
                report["ms"] += n * ms
                report["plain_ms"] += n * plain_ms
                report["bound_ms"] += n * bound_ms
                if n * bound_ms > report.get("top_bound", 0.0):
                    report["top_bound"], report["bound_by"] = n * bound_ms, bound_by
                report[f"{shape}_ms"] = ms
                report[f"{shape}_bound_ms"] = bound_ms
    log(f"K1 per decode batch (12 + 6 + 6 calls, bf16): kernel "
        f"{report['ms']:.3f} ms, plain {report['plain_ms']:.3f} ms, bound "
        f"{report['bound_ms']:.4f} ms = {report['bound_ms'] / report['ms']:.2%} "
        f"of it [{name}]")
    return report


def train_slice_inputs(gen, dev, dtype, bh=TRAIN_BH, t=TRAIN_T):
    """One conformer self-attention call of a training micro-batch: B=32 x
    4 heads (bh / 4 x 4 heads), T'=199 (t), Dk=64, the table shared over
    the batch; row 5 has kv_len 0."""
    d = TRAIN_D

    def rnd(*shape):
        return (0.5 * torch.randn(*shape, generator=gen)).to(dev, dtype)

    kv = torch.randint(t // 2, t + 1, (bh // HEADS,), generator=gen)
    kv = kv.repeat_interleave(HEADS)
    kv[0], kv[5] = t, 0
    return dict(q_u=rnd(bh, t, d), qv=rnd(bh, t, d), k=rnd(bh, t, d),
                v=rnd(bh, t, d), p=rnd(HEADS, t, d),
                kv_lens=kv.to(dev, torch.int32),
                dout=torch.randn(bh, t, d, generator=gen).to(dev))


def check_train_kernels(fa, dev, name):
    """K1' (lse + dropout) and K2 vs their plain versions at the training
    shape; times kernel and plain forward + backward."""
    gen = torch.Generator().manual_seed(SEED + 1)
    scale = TRAIN_D ** -0.5
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = train_slice_inputs(gen, dev, dtype)
        ins = [x[n] for n in ("q_u", "qv", "k", "v", "p")]
        kv, dout = x["kv_lens"], x["dout"]

        def fwd(plain=False):
            f = fa.flash_attention_plain if plain else fa.flash_attention
            return f(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1],
                     rel_p=ins[4], scale=scale, return_lse=True,
                     dropout_rate=TRAIN_RATE, dropout_seed=TRAIN_SEED)

        def bwd(out, lse, plain=False):
            f = fa.flash_rel_attention_bwd_plain if plain else fa.flash_rel_attention_bwd
            return f(*ins, kv, out, lse, dout, scale, TRAIN_RATE, TRAIN_SEED)

        out, lse = fwd()
        ref_out, ref_lse = fwd(plain=True)
        out32 = out.float()
        grads = bwd(out32, lse)
        ref_grads = bwd(out32, ref_lse, plain=True)
        torch.cuda.synchronize()
        ftol, gtol = KERNEL_TOL[dtype], GRAD_TOL[dtype]
        live = kv > 0
        errs = {"out": (out.float() - ref_out.float()).abs().max().item(),
                "lse": (lse[live] - ref_lse[live]).abs().max().item()}
        ok = (within(out, ref_out, ftol) and within(lse[live], ref_lse[live], ftol)
              and bool((lse[~live] == fa.NEG_INF).all()))
        for gname, g, r in zip(("dq_u", "dqv", "dk", "dv", "dp"), grads, ref_grads):
            g = g.to(dtype).float()  # what K3 hands back
            errs[gname] = (g - r).abs().max().item()
            ok = ok and within(g, r, gtol)
            if gname != "dp":
                ok = ok and bool((g[5] == 0).all())  # the dead row
        line = " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        if not ok:
            raise RuntimeError(f"K1'/K2 {dtype}: {line} beyond tol "
                               f"{ftol}/{gtol} (or the dead row is not 0)")

        def kernel_step():
            o, l = fwd()
            bwd(o.float(), l)

        def plain_step():
            o, l = fwd(plain=True)
            bwd(o.float(), l, plain=True)

        fwd_ms = cuda_time_ms(fwd)
        fwd_plain = cuda_time_ms(lambda: fwd(plain=True))
        bwd_ms = cuda_time_ms(lambda: bwd(out32, lse))
        bwd_plain = cuda_time_ms(lambda: bwd(out32, ref_lse, plain=True))
        step_ms, step_plain = cuda_time_ms(kernel_step), cuda_time_ms(plain_step)
        fb, fb_by = fwd_bound(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1],
                              rel_p=ins[4], lse=True)
        bb, bb_by = bwd_bound(*ins, kv, out32, lse, dout)
        log(f"K1'/K2 {str(dtype)[6:]} BH={TRAIN_BH} T'={TRAIN_T} D={TRAIN_D} "
            f"dropout {TRAIN_RATE}: {line} (tol {ftol}/{gtol}); fwd kernel "
            f"{fwd_ms:.4f} ms plain {fwd_plain:.4f} bound {fb:.4f} ({fb_by}, "
            f"{fb / fwd_ms:.2%}); bwd kernel {bwd_ms:.4f} ms plain {bwd_plain:.4f} "
            f"bound {bb:.4f} ({bb_by}, {bb / bwd_ms:.2%}); fwd+bwd kernel "
            f"{step_ms:.4f} ms plain {step_plain:.4f} [{name}]")
        if dtype == torch.bfloat16:
            report = {"fwd_err": max(errs["out"], errs["lse"]),
                      "bwd_err": max(errs[g] for g in ("dq_u", "dqv", "dk", "dv", "dp")),
                      "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain,
                      "fwd_bound_ms": fb, "fwd_bound_by": fb_by,
                      "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain,
                      "bwd_bound_ms": bb, "bwd_bound_by": bb_by}
    return report


def time_long_kernels(fa, dev, name):
    """K1' and K2 in bf16 at a long utterance (BH=32, T'=1499, D=64,
    dropout 0.1), held against the plain versions and timed."""
    gen = torch.Generator().manual_seed(SEED + 3)
    bh, t, d = LONG_BH, LONG_T, TRAIN_D
    scale = d ** -0.5
    x = train_slice_inputs(gen, dev, torch.bfloat16, bh, t)
    ins = [x[n] for n in ("q_u", "qv", "k", "v", "p")]
    kv, dout = x["kv_lens"], x["dout"]
    live = kv > 0

    def fwd(plain=False):
        f = fa.flash_attention_plain if plain else fa.flash_attention
        return f(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4],
                 scale=scale, return_lse=True, dropout_rate=TRAIN_RATE,
                 dropout_seed=TRAIN_SEED)

    out, lse = fwd()
    ref_out, ref_lse = fwd(plain=True)
    out32 = out.float()
    grads = fa.flash_rel_attention_bwd(*ins, kv, out32, lse, dout, scale,
                                       TRAIN_RATE, TRAIN_SEED)
    ref_grads = fa.flash_rel_attention_bwd_plain(*ins, kv, out32, ref_lse, dout,
                                                 scale, TRAIN_RATE, TRAIN_SEED)
    torch.cuda.synchronize()
    ok = within(out, ref_out, KERNEL_TOL[torch.bfloat16]) and within(
        lse[live], ref_lse[live], KERNEL_TOL[torch.bfloat16])
    gerr = 0.0
    for g, r in zip(grads, ref_grads):
        g = g.to(torch.bfloat16).float()
        gerr = max(gerr, (g - r).abs().max().item())
        ok = ok and within(g, r, GRAD_TOL[torch.bfloat16])
    ferr = (out.float() - ref_out.float()).abs().max().item()
    if not ok:
        raise RuntimeError(f"K1'/K2 at T'={t}: out err {ferr}, grad err {gerr}")
    del ref_out, ref_lse, ref_grads
    fwd_ms = cuda_time_ms(fwd)
    bwd_ms = cuda_time_ms(lambda: fa.flash_rel_attention_bwd(
        *ins, kv, out32, lse, dout, scale, TRAIN_RATE, TRAIN_SEED))
    fb, fb_by = fwd_bound(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1],
                          rel_p=ins[4], lse=True)
    bb, bb_by = bwd_bound(*ins, kv, out32, lse, dout)
    log(f"K1'/K2 bf16 long BH={bh} T'={t} D={d} dropout {TRAIN_RATE}: out err "
        f"{ferr:.3g} grad err {gerr:.3g}; fwd kernel {fwd_ms:.4f} ms bound {fb:.4f} "
        f"({fb_by}, {fb / fwd_ms:.2%}); bwd kernel {bwd_ms:.4f} ms bound {bb:.4f} "
        f"({bb_by}, {bb / bwd_ms:.2%}) [{name}]")


def write_split(root, split, n, min_t, max_t, min_u, max_u, rng):
    from liteasr_tpu_torch.data import kaldi_io

    d = os.path.join(root, split)
    os.makedirs(d)
    lens = rng.integers(min_t, max_t + 1, n)
    lens[0] = max_t
    mats, texts, frames = {}, [], []
    for i, t in enumerate(lens):
        uttid = f"{split}{i:03d}"
        mats[uttid] = rng.normal(size=(int(t), FEAT)).astype(np.float32)
        words = rng.integers(0, VOCAB - 3, int(rng.integers(min_u, max_u + 1)))
        texts.append(f"{uttid} " + " ".join(f"w{w}" for w in words))
        frames.append(f"{uttid} {int(t)}")
    kaldi_io.save_ark(os.path.join(d, "feats.ark"), mats,
                      scp_path=os.path.join(d, "feats.scp"))
    with open(os.path.join(d, "utt2num_frames"), "w") as f:
        f.write("\n".join(frames) + "\n")
    with open(os.path.join(d, "text"), "w") as f:
        f.write("\n".join(texts) + "\n")
    return d


def write_corpus(root: str) -> None:
    rng = np.random.default_rng(SEED)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        # <blank> and <sos/eos> complete the file's VOCAB - 2 tokens
        f.write("<unk> 1\n" + "".join(f"w{i} {i + 2}\n" for i in range(VOCAB - 3)))
    write_split(root, "test", N_UTT, MIN_T, MAX_T, 20, 60, rng)
    write_split(root, "train", N_TRAIN, TRAIN_MIN_T, TRAIN_MAX_T, 24, 48, rng)
    write_split(root, "valid", N_VALID, TRAIN_MIN_T, TRAIN_MAX_T, 24, 48, rng)


def build_model(dtype, device, enc_layers=ENC_LAYERS, dec_layers=DEC_LAYERS,
                dropout_rate=0.0, remat=False, **streaming):
    """The full-width U2 (my_U2), random weights from SEED; ``streaming``:
    enc_arch, static_chunk_size, dynamic_chunk."""
    from liteasr_tpu_torch.models.u2 import U2

    gen = torch.Generator().manual_seed(SEED)
    rates = {k: dropout_rate for k in (
        "dropout_rate", "enc_dropout_rate", "enc_pos_dropout_rate",
        "enc_attn_dropout_rate", "enc_ff_dropout_rate", "dec_dropout_rate",
        "dec_pos_dropout_rate", "dec_self_attn_dropout_rate",
        "dec_src_attn_dropout_rate", "dec_ff_dropout_rate")}
    return U2(input_dim=FEAT, vocab_size=VOCAB, enc_dim=DIM, enc_ff_dim=2048,
              enc_attn_heads=HEADS, enc_layers=enc_layers, dec_dim=DIM,
              dec_ff_dim=2048, dec_attn_heads=HEADS, dec_layers=dec_layers,
              remat=remat, dtype=dtype, device=device, generator=gen, **rates,
              **streaming)


def run_slice(fa, task, dev, name, mode="attention_rescore", model=None):
    """Decodes the test corpus in ``mode`` with ``model`` (default the bf16
    conformer U2): a warm-up pass, then the timed pass with the counts
    reset; returns the K1 launches and s/batch."""
    from liteasr_tpu_torch.infer import infer_dataset

    dataset = task.dataset("test")
    model = model or build_model(torch.bfloat16, dev)
    cfg = {"batch_size": BATCH, "beam_size": BEAM, "ctc_weight": CTC_WEIGHT,
           "mode": mode}
    n_batches = -(-len(dataset.data) // BATCH)
    audio_s = sum(a.xlen for a in dataset.data) * FRAME_S

    infer_dataset(task, model, dataset, cfg, dev, PAD_TIME, verbose=False)  # warm-up
    torch.cuda.synchronize()
    reset_counts(fa)
    t0 = time.perf_counter()
    pairs = []
    err, length = infer_dataset(task, model, dataset, cfg, dev, PAD_TIME,
                                verbose=False, collect=pairs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    # attention_rescore: the encoder and the rescoring decoder; attention:
    # the encoder only (the cached beam's step attention is plain)
    per_batch = ENC_LAYERS + (2 * DEC_LAYERS if mode == "attention_rescore" else 0)
    if launches != per_batch * n_batches:
        raise RuntimeError(f"K1 launched {launches} times for {n_batches} "
                           f"batches, expected {per_batch} per batch")
    # a static chunk width reaches the encoder's K1 launches, never the decoder's
    chunked = ENC_LAYERS * n_batches if model.encoder.static_chunk_size else 0
    if chunk_counts(fa) != (chunked, 0, 0):
        raise RuntimeError(f"chunked (K1, K1', K2) launches {chunk_counts(fa)}, "
                           f"expected ({chunked}, 0, 0)")
    if len(pairs) != len(dataset.data) or length <= 0:
        raise RuntimeError("infer_dataset did not score every utterance")
    log(f"slice {mode}: {n_batches} batches of <= {BATCH} utts (longest padded "
        f"to 1600 frames), {secs / n_batches:.4f} s/batch, "
        f"{len(pairs) / secs:.2f} utt/s, RTF {secs / audio_s:.5f}, "
        f"K1 launches {launches} ({per_batch}/batch), "
        f"error count {err}/{length} (random weights) [{name}]")
    return launches, secs / n_batches


def check_parity(task, dev, name):
    """2 utterances in fp32: GPU (kernel) vs CPU (plain path)."""
    from liteasr_tpu_torch import decode

    data = task.dataset("test").data[:2]
    T = max(a.xlen for a in data)
    xs = np.zeros((2, T, FEAT), np.float32)
    for i, a in enumerate(data):
        xs[i, :a.xlen] = a.x
    xs = torch.from_numpy(xs)
    xlens = torch.tensor([a.xlen for a in data])
    outs = []  # [GPU, CPU]
    for device in (dev, torch.device("cpu")):
        model = build_model(torch.float32, device)
        with torch.inference_mode():
            h_enc, _ = model.encode(xs.to(device), xlens.to(device))
            logp = torch.log_softmax(model.ctc_logits(h_enc).float(), -1)
        hyps = decode.decode_batch(model, xs.to(device), xlens.to(device),
                                   beam_size=BEAM, ctc_weight=CTC_WEIGHT)
        outs.append((h_enc.cpu(), logp.cpu(), hyps))
    (g_enc, g_logp, g_hyps), (c_enc, c_logp, c_hyps) = outs
    enc_err = (g_enc - c_enc).abs().max().item()
    ctc_err = (g_logp - c_logp).abs().max().item()
    agree = np.mean([a == b for a, b in zip(g_hyps, c_hyps)])
    log(f"parity fp32 GPU vs CPU (2 utts): encoder max abs diff {enc_err:.3g}, "
        f"CTC log-prob max abs diff {ctc_err:.3g} (bound {PARITY_TOL}); "
        f"hypotheses agree {agree:.2f} [{name}]")
    if not (enc_err <= PARITY_TOL and ctc_err <= PARITY_TOL):
        raise RuntimeError("GPU and CPU paths disagree beyond the bound")


# the model and criterion presets of each family that train.main runs
FAMILY_PRESETS = {"u2": ("my_U2", "my_hybrid_ctc"), "rnnt": ("my_transducer", "my_rnnt"),
                  "paraformer": ("Paraformer", "paraformer_loss")}


def train_overrides(family, root, run, epochs):
    """train.main's overrides of ``family`` (:data:`FAMILY_PRESETS`) in
    bf16, dropout 0.1, my_noam, clip 5, accum 2, on the corpus under
    ``root`` (phases 6, g, p, x, z2, z5, z8)."""
    model, criterion = FAMILY_PRESETS[family]
    return [
        "task=asr", f"model={model}", f"criterion={criterion}",
        "optimizer=my_noam", f"task.vocab={root}/vocab.txt",
        f"task.train={root}/train", f"task.valid={root}/valid",
        f"task.test=[{root}/valid]", "task.delimiter=' '",
        f"task.save_dir={run}/ckpts", f"common.run_dir={run}",
        f"common.seed={SEED}", "model.dtype=bfloat16",
        "model.dropout_rate=0.1", f"dataset.batch_size={TRAIN_BATCH}",
        "dataset.max_len_in=1000", "postprocess.workflow=[]",
        f"optimization.max_epoch={epochs}",
        f"optimization.accum_grad={ACCUM}", "optimization.clip_grad_norm=5.0"]


def run_training(fa, root, dev, name):
    """train.main at full width; returns the forward (K1 and K1'), K1' and
    K2 launches of the training run and the K1 launches of the decode of
    its checkpoint (counts reset before each)."""
    from liteasr_tpu_torch import infer, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    run = os.path.join(root, "run")
    overrides = train_overrides("u2", root, run, TRAIN_EPOCHS)
    reset_counts(fa)
    t0 = time.perf_counter()
    trainer = train.main(overrides, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fwd, lse, bwd = counts(fa)
    micro = TRAIN_EPOCHS * len(trainer.task.dataset("train"))
    n_valid = TRAIN_EPOCHS * len(trainer.valid_set)
    losses = torch.stack(trainer._loss_accum).float().cpu()
    if (lse, bwd, fwd - lse) != (ENC_LAYERS * micro, ENC_LAYERS * micro,
                                 (ENC_LAYERS + 2 * DEC_LAYERS) * n_valid):
        raise RuntimeError(f"launches K1' {lse}, K2 {bwd}, K1 {fwd - lse} for "
                           f"{micro} micro-batches and {n_valid} valid batches")
    if len(losses) != micro or not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"training losses {losses.tolist()}")
    init = dict(build_model(torch.bfloat16, "cpu").named_parameters())
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach().cpu(), init[n])]  # same seed as train.main
    if int(trainer.tx.count) < 1 or len(moved) < len(init) // 2:
        raise RuntimeError(f"{int(trainer.tx.count)} steps applied, "
                           f"{len(moved)} parameters moved")
    with open(os.path.join(run, "train.log")) as f:
        valid_lines = [ln for ln in f if "valid loss:" in ln]
    if len(valid_lines) != TRAIN_EPOCHS:
        raise RuntimeError(f"{len(valid_lines)} 'valid loss:' lines")
    ckpt = os.path.join(run, "ckpts", f"model.ep.{TRAIN_EPOCHS}.pt")
    if not os.path.isfile(ckpt):
        raise RuntimeError(f"{ckpt} was not written")
    log(f"train: {micro} micro-batches of <= {TRAIN_BATCH} utts in "
        f"{TRAIN_EPOCHS} epochs, {int(trainer.tx.count)} optimizer steps "
        f"({int(trainer.tx.notfinite_count)} skipped), {secs:.2f} s incl. "
        f"validation and checkpoints; losses {[round(x, 3) for x in losses.tolist()]}; "
        f"K1' {lse}, K2 {bwd}, K1 {fwd - lse} launches; "
        f"{len(moved)} parameter leaves moved; {valid_lines[-1].split(' - ')[-1].strip()} "
        f"[{name}]")

    cfg = compose([f"inference.ckpt_name={TRAIN_EPOCHS}",
                   "inference.model_avg=false", f"inference.batch_size={N_VALID}",
                   f"inference.beam_size={BEAM}"],
                  base=load_yaml(os.path.join(run, "config.yaml")))
    reset_counts(fa)
    results = infer.infer(cfg, device=dev)
    torch.cuda.synchronize()
    dec_fwd = counts(fa)[0]
    if dec_fwd != ENC_LAYERS + 2 * DEC_LAYERS or results[0][1] <= 0:
        raise RuntimeError(f"decoding the checkpoint: {results}, K1 {dec_fwd}")
    log(f"decoded {ckpt.split('/')[-1]}: error count {results[0][0]}/"
        f"{results[0][1]} (2 epochs on random data), K1 launches {dec_fwd} [{name}]")
    return fwd, lse, bwd, dec_fwd


def bench_batch(dev):
    """bench.py:179-187's fixed batch: B=32, T=800, U=48, vocab 5000."""
    B, T, U = 32, 800, 48
    rng = np.random.default_rng(0)
    batch = {
        "xs": rng.normal(size=(B, T, FEAT)).astype(np.float32),
        "xlens": rng.integers(T // 2, T + 1, size=B).astype(np.int32),
        "ys": rng.integers(1, VOCAB - 1, size=(B, U)).astype(np.int32),
        "ylens": rng.integers(U // 2, U + 1, size=B).astype(np.int32),
        "valid": np.ones((B,), np.float32),
    }
    from liteasr_tpu_torch.trainer import to_device

    return to_device(batch, dev), B


def bench_step(dev, remat=False, shard=False, **streaming):
    """The full-width bf16 train micro-step (dropout 0.1, hybrid loss, Noam
    Adam, clip 5, accum 2) on bench_batch; returns (step, B). Inside a
    process group the optimizer all-reduces its flat gradient (phase y);
    ``shard``: on this rank's tp/sp shard of the model (z4)."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.parallel import sharding
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam
    from liteasr_tpu_torch.optims.noam import noam_schedule

    torch.manual_seed(SEED)
    model = build_model(torch.bfloat16, dev, dropout_rate=0.1, remat=remat, **streaming)
    if shard:
        sharding.shard_model(model, parallel.layout())
    crit = HybridCTCLoss(DotDict(vocab_size=VOCAB, padding_idx=-1,
                                 smoothing=0.1, ctc_weight=0.3))
    params = list(model.parameters())
    tx = FusedAdam(params, noam_schedule(256, 1.0, 25000), 0.9, 0.98, 1e-9,
                   clip=5.0, accum=ACCUM, sharded=sharding.sharded_parameters(model))
    batch, B = bench_batch(dev)

    def step():
        loss, _ = crit(model, batch, train=True)
        loss.backward()
        tx.update([p.grad for p in params])
        for p in params:
            p.grad = None
        return loss

    step.params = params
    return step, B


def traced_steps(step, steps, activities):
    """Runs ``steps`` micro-steps under torch.profiler. Returns the profiler,
    the wall time in us, the device-busy time in us (the union of the device
    intervals) and the number of device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return prof, wall_us, busy, len(spans)


def time_train_step(dev, name):
    """Median of 5 repetitions of 10 micro-steps at bench.py's point, then
    10 micro-steps traced with device activity only (no host-op records,
    so the host runs near its untraced speed) for the device-busy share."""
    from torch.profiler import ProfilerActivity

    sys.path.insert(0, REPO)
    from bench import train_step_flops  # imports jax only inside its main()

    step, B = bench_step(dev)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10):
            loss = step()
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite loss in the timed steps")
    med = statistics.median(reps) / 10
    flops = train_step_flops(VOCAB)
    log(f"train step at bench.py's point (B={B}, T=800, U=48, bf16, accum "
        f"{ACCUM}): median {med * 1e3:.2f} ms/micro-step (best "
        f"{min(reps) * 100:.2f}), {B / med:.2f} utt/s, {flops / 1e12:.3f} "
        f"TFLOP/step (bench.train_step_flops), MFU {flops / med / H100_BF16_PEAK:.4%} "
        f"of {H100_BF16_PEAK / 1e12:.0f} TFLOP/s dense bf16; peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{name}]")
    _, wall_us, busy, ops = traced_steps(step, 10, [ProfilerActivity.CUDA])
    log(f"device busy (10 micro-steps traced with device activity only): "
        f"{busy / 1e4:.2f} ms/micro-step of {wall_us / 1e4:.2f} ms traced wall "
        f"= {busy / wall_us:.1%} measured; traced wall / untraced median "
        f"{wall_us / 1e7 / med:.3f}; derived estimate, traced device time over "
        f"the untraced median: {busy / 1e7 / med:.1%}; {ops / 10:.0f} device "
        f"ops/micro-step [{name}]")
    return med * 1e3


def profile_train_step(dev, name, steps: int = 4):
    """``--profile-train``: host and device torch.profiler over ``steps``
    micro-steps at bench.py's point. Prints the top kernels by device time;
    the host-op records slow the host, so the busy share it prints is lower
    than the untraced step's (time_train_step measures that one)."""
    from torch.profiler import ProfilerActivity

    step, _ = bench_step(dev)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    prof, wall_us, busy, ops = traced_steps(
        step, steps, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    log(f"profile: {steps} micro-steps, wall {wall_us / 1e3 / steps:.2f} ms/step "
        f"(under the host+device profiler), device busy {busy / 1e3 / steps:.2f} "
        f"ms/step = {busy / wall_us:.1%}, {ops / steps:.0f} device ops/step [{name}]")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30,
                                  max_name_column_width=60))


def check_train_parity(dev, name):
    """One fp32 train step, 2 + 1 layers at full width, dropout 0: GPU
    (kernels) vs CPU (plain path)."""
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss
    from liteasr_tpu_torch.trainer import to_device

    rng = np.random.default_rng(SEED + 2)
    B, T, U = 4, 400, 24
    batch = {"xs": rng.normal(size=(B, T, FEAT)).astype(np.float32),
             "xlens": np.array([T, 350, 280, 200], np.int32),
             "ys": rng.integers(1, VOCAB - 1, size=(B, U)).astype(np.int32),
             "ylens": np.array([U, 20, 16, 10], np.int32),
             "valid": np.ones(B, np.float32)}
    crit = HybridCTCLoss(DotDict(vocab_size=VOCAB, padding_idx=-1,
                                 smoothing=0.1, ctc_weight=0.3))
    res = []
    for device in (dev, torch.device("cpu")):
        model = build_model(torch.float32, device, enc_layers=2, dec_layers=1)
        loss, _ = crit(model, to_device(batch, device), train=True)
        loss.backward()
        res.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (g_loss, g_grads), (c_loss, c_grads) = res
    what = grad_agreement(g_loss, g_grads, c_loss, c_grads)
    log(f"train parity fp32 GPU vs CPU (2+1 layers, B={B}, T={T}): {what} [{name}]")


def grad_agreement(g_loss, g_grads, c_loss, c_grads) -> str:
    """The train-parity rule: loss and every gradient leaf within
    PARITY_TOL of the reference leaf's own max, except the leaves whose
    gradient is 0 in exact arithmetic: the depthwise-conv bias (train-mode
    BatchNorm subtracts the batch mean) and every attention key bias (it
    shifts a query's scores over all keys alike, which softmax ignores).
    Their gradient is rounding noise, so they are held to max abs diff <=
    PARITY_TOL x the largest gradient of the step, and their reference
    gradient must itself be below that. Raises beyond the bound; returns
    the summary."""
    top = max(c.abs().max().item() for c in c_grads.values())
    errs, zero_leaves = {}, {}
    for n, c in c_grads.items():
        diff, peak = (g_grads[n] - c).abs().max().item(), c.abs().max().item()
        errs[n] = diff / peak if peak > 0 else (0.0 if diff == 0 else float("inf"))
        if n.endswith((".conv.depthwise_conv.bias", ".linear_k.bias")):
            zero_leaves[n] = (diff / top, peak / top)
    rel = sorted((n for n in errs if n not in zero_leaves), key=errs.get)
    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    zero_worst = max(d for d, _ in zero_leaves.values())
    zero_peak = max(p for _, p in zero_leaves.values())
    what = (f"loss {g_loss:.6f} vs {c_loss:.6f} (rel {loss_err:.3g}); worst grads of "
            f"{len(rel)} leaves held to their own max: "
            f"{', '.join(f'{n} {errs[n]:.3g}' for n in rel[:-4:-1])}; "
            f"{len(zero_leaves)} leaves with an exactly-0 gradient (depthwise-conv "
            f"and key biases) held to the largest gradient: diff {zero_worst:.3g}, "
            f"own max {zero_peak:.3g} of it (diff over own max up to "
            f"{max(errs[n] for n in zero_leaves):.3g}); bound {PARITY_TOL}")
    worst = rel[-1]
    if (loss_err > PARITY_TOL or errs[worst] > PARITY_TOL
            or zero_worst > PARITY_TOL or zero_peak > PARITY_TOL):
        raise RuntimeError(f"the train steps disagree beyond the bound: {what}")
    return what


# ------------------------------------------- the recipe on raw waves (a-f)


def write_wave_corpus(root: str) -> str:
    """80 train and 16 valid utterances of noise at varied loudness, 4-8 s
    at 16 kHz (398-798 fbank frames), 24-48 tokens, as wav files with a
    wav.scp and a text each; the vocabulary of write_corpus."""
    from liteasr_tpu_torch.data import kaldi_io

    rng = np.random.default_rng(SEED + 4)
    out = os.path.join(root, "waves")
    lo, hi = int(WAVE_MIN_S * WAVE_RATE), int(WAVE_MAX_S * WAVE_RATE)
    for split, n in (("train", N_WAVE_TRAIN), ("valid", N_WAVE_VALID)):
        d = os.path.join(out, split)
        os.makedirs(d)
        lens = rng.integers(lo, hi + 1, n)
        lens[0] = hi
        scp, text = [], []
        for i, length in enumerate(lens):
            uttid = f"{split}{i:03d}"
            path = os.path.join(d, f"{uttid}.wav")
            amp = 10.0 ** rng.uniform(-2.5, -0.7)
            kaldi_io.write_wav(path, (rng.normal(size=int(length)) * amp).astype(np.float32),
                               WAVE_RATE)
            scp.append(f"{uttid} {path}")
            words = rng.integers(0, VOCAB - 3, int(rng.integers(24, 49)))
            text.append(f"{uttid} " + " ".join(f"w{w}" for w in words))
        with open(os.path.join(d, "wav.scp"), "w") as f:
            f.write("\n".join(scp) + "\n")
        with open(os.path.join(d, "text"), "w") as f:
            f.write("\n".join(text) + "\n")
    return out


def check_frontend(wave_root, dev, name):
    """Phase a: fbank and SpecAugment of one train batch of 32 on the card
    against the CPU, SpecAugment's contract, and both timed."""
    from liteasr_tpu_torch.data import kaldi_io
    from liteasr_tpu_torch.ops import fbank
    from liteasr_tpu_torch.ops import spec_augment as sa
    from liteasr_tpu_torch.utils.misc import round_up

    with open(os.path.join(wave_root, "train", "wav.scp")) as f:
        paths = [ln.split()[1] for ln in f][:TRAIN_BATCH]
    waves = [kaldi_io.read_wav(p)[0].astype(np.float32) for p in paths]
    x = np.zeros((len(waves), round_up(max(map(len, waves)), 128)), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    xc = torch.from_numpy(x)
    lc = torch.tensor([len(w) for w in waves], dtype=torch.int32)
    xg, lg = xc.to(dev), lc.to(dev)
    cpu_f, cpu_l = fbank.log_mel_fbank(xc, lc)
    feats, flens = fbank.log_mel_fbank(xg, lg)
    torch.cuda.synchronize()
    empty = torch.from_numpy(fbank.mel_filterbank(FEAT, 512, WAVE_RATE).sum(0) == 0)
    got = feats.cpu()
    diff = (got - cpu_f).abs()
    f_err = diff.max().item()
    over = (diff > 1e-4).float().mean().item()
    worst_bin = int(diff.amax(dim=(0, 1)).argmax())
    if not (torch.equal(flens.cpu(), cpu_l) and f_err <= FBANK_TOL
            and bool((got[..., empty] == 0).all()) and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"fbank card vs CPU: max abs err {f_err} (bound {FBANK_TOL}, "
                           f"worst mel bin {worst_bin}), or an empty mel bin is not 0")
    fbank_ms = cuda_time_ms(lambda: fbank.log_mel_fbank(xg, lg), reps=10, inner=5)

    def augment(step):
        return sa.spec_augment(feats, flens, sa.step_generator(SEED, step, dev), **SPEC_AUG)

    a = augment(7)
    if not torch.equal(a, augment(7)) or torch.equal(a, augment(8)):
        raise RuntimeError("SpecAugment is not one result per (seed, step)")
    draws = sa.draw(flens, FEAT, sa.step_generator(SEED, 7, dev),
                    SPEC_AUG["time_warp"], SPEC_AUG["freq_mask"],
                    SPEC_AUG["freq_mask_times"], SPEC_AUG["time_mask"],
                    SPEC_AUG["time_mask_times"])
    xl, W = flens.long(), SPEC_AUG["time_warp"]
    in_range = [
        (draws["center"] >= W) & (draws["center"] < torch.clamp(xl - W, min=W + 1)),
        (draws["warped"] >= 1) & (draws["warped"] <= xl - 1),
        (draws["freq_width"] < SPEC_AUG["freq_mask"]) & (draws["freq_start"] < FEAT),
        (draws["time_width"] < SPEC_AUG["time_mask"]) & (draws["time_start"] < xl[:, None])]
    if not all(bool(c.all()) for c in in_range):
        raise RuntimeError("SpecAugment draws out of their ranges")
    out = sa.apply(feats, flens, draws, W)
    ref = sa.apply(feats.cpu(), flens.cpu(), {k: v.cpu() for k, v in draws.items()}, W)
    sa_err = (out.cpu() - ref).abs().max().item()
    if not within(out.cpu(), ref, SPEC_AUG_TOL):
        raise RuntimeError(f"SpecAugment card vs CPU at the same draws: {sa_err}")
    f_idx = torch.arange(FEAT, device=dev)
    band = ((f_idx >= draws["freq_start"][..., None])
            & (f_idx < (draws["freq_start"] + draws["freq_width"])[..., None])).any(1)
    pad = torch.arange(feats.shape[1], device=dev)[None, :, None] >= xl[:, None, None]
    keep = pad & ~band[:, None, :]
    if not torch.equal(out[keep], feats[keep]) or torch.equal(out, feats):
        raise RuntimeError("SpecAugment touched the padding outside its frequency "
                           "masks, or did nothing")
    sa_ms = cuda_time_ms(lambda: augment(7), reps=10, inner=5)
    log(f"front end (batch of {len(waves)} waves of {x.shape[1]} samples -> "
        f"{tuple(feats.shape)} fbank): card vs CPU max abs err {f_err:.3g} (bound "
        f"{FBANK_TOL}; worst in mel bin {worst_bin}; {over:.3%} of the values differ "
        f"by more than 1e-4; the {int(empty.sum())} empty mel filters 0); SpecAugment card vs CPU at the same draws "
        f"{sa_err:.3g} (bound {SPEC_AUG_TOL}), draws in range, padding untouched "
        f"outside the frequency masks, one result per (seed, step); fbank "
        f"{fbank_ms:.4f} ms/batch, SpecAugment {sa_ms:.4f} ms/batch [{name}]")


def valid_epochs(log_path):
    with open(log_path) as f:
        return [int(re.search(r"(\d+) / \S+ epochs - valid loss", ln).group(1))
                for ln in f if "valid loss:" in ln]


def run_recipe(fa, root, wave_root, dev, name):
    """Phase b: the recipe through train.main, 1 epoch then a resume to 3.
    Returns the run dir and the (K1, K1', K2) launches of both runs."""
    from liteasr_tpu_torch import train

    run = os.path.join(root, "recipe")
    overrides = [
        "task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_noam",
        f"task.vocab={root}/vocab.txt", f"task.train={wave_root}/train",
        f"task.valid={wave_root}/valid", f"task.test=[{wave_root}/valid]",
        "task.delimiter=' '", f"task.save_dir={run}/ckpts", f"common.run_dir={run}",
        f"common.seed={SEED}", "model.dtype=bfloat16", "model.dropout_rate=0.1",
        "model.remat=true", "dataset.fbank=true", f"dataset.batch_size={TRAIN_BATCH}",
        "dataset.max_len_in=200000", f"optimization.accum_grad={ACCUM}",
        "optimization.clip_grad_norm=5.0"]  # postprocess: the default spec_aug on device
    totals = [0, 0, 0]
    trainers = []
    for extra in (["optimization.max_epoch=1"],
                  [f"optimization.max_epoch={RECIPE_EPOCHS}", "common.resume=auto"]):
        reset_counts(fa)
        t0 = time.perf_counter()
        trainer = train.main(overrides + extra, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        fwd, lse, bwd = counts(fa)
        epochs = trainer.epoch - (trainers[-1].epoch if trainers else 0)
        micro = trainer.step - (trainers[-1].step if trainers else 0)
        n_valid = epochs * len(trainer.valid_set)
        if (trainer.spec_aug is None or trainer.fbank_bins != FEAT
                or not trainer.model.encoder.remat):
            raise RuntimeError("the recipe run lacks fbank, SpecAugment or remat")
        if (lse, bwd, fwd - lse) != (2 * ENC_LAYERS * micro, ENC_LAYERS * micro,
                                     (ENC_LAYERS + 2 * DEC_LAYERS) * n_valid):
            raise RuntimeError(f"launches K1' {lse}, K2 {bwd}, K1 {fwd - lse} for "
                               f"{micro} micro-batches (remat) and {n_valid} valid batches")
        losses = torch.stack(trainer._loss_accum).float().cpu()
        if len(losses) != micro or not bool(torch.isfinite(losses).all()):
            raise RuntimeError(f"recipe losses {losses.tolist()}")
        log(f"recipe {'resumed ' if trainers else ''}to epoch {trainer.epoch}: "
            f"{micro} micro-batches (iter {trainer.iter}, step {trainer.step}, "
            f"{int(trainer.tx.count)} optimizer steps, {int(trainer.tx.notfinite_count)} "
            f"skipped) in {secs:.2f} s incl. validation and checkpoints; losses "
            f"{[round(v, 3) for v in losses.tolist()]}; K1' {lse} ({lse // max(micro, 1)}"
            f"/micro-batch with the recompute), K2 {bwd}, K1 {fwd - lse} [{name}]")
        if not trainers:
            with open(os.path.join(run, "ckpts", "train_state.pt.meta")) as f:
                meta = json.load(f)
            if meta != {"iter": trainer.iter, "epoch": 1}:
                raise RuntimeError(f"train_state meta {meta}")
        elif (trainer.epoch, trainer.step) != (RECIPE_EPOCHS, RECIPE_EPOCHS * trainers[0].step):
            raise RuntimeError(f"the resumed run ended at epoch {trainer.epoch}, "
                               f"step {trainer.step}")
        totals = [a + b for a, b in zip(totals, (fwd - lse, lse, bwd))]
        trainers.append(trainer)
    epochs = valid_epochs(os.path.join(run, "train.log"))
    missing = [e for e in range(1, RECIPE_EPOCHS + 1)
               if not os.path.isfile(os.path.join(run, "ckpts", f"model.ep.{e}.pt"))]
    if epochs != list(range(1, RECIPE_EPOCHS + 1)) or missing:
        raise RuntimeError(f"valid lines for epochs {epochs}, missing checkpoints {missing}")
    log(f"recipe resume: iter {trainers[0].iter} -> {trainers[1].iter}, epoch 1 -> "
        f"{trainers[1].epoch}; valid lines for epochs {epochs}, no event repeated; "
        f"model.ep.1-{RECIPE_EPOCHS}.pt written [{name}]")
    return run, totals


def run_averaged_attention(fa, run, dev, name):
    """Phase c: infer.infer of the recipe run, averaged N-best, attention
    mode. Returns the K1 launches."""
    from liteasr_tpu_torch import checkpoint, infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    cfg = compose([f"inference.ckpt_name={RECIPE_EPOCHS}", "inference.model_avg=true",
                   "inference.avg_num=2", f"inference.avg_policy={run}",
                   "inference.mode=attention", f"inference.batch_size={N_WAVE_VALID}",
                   f"inference.beam_size={BEAM}"],
                  base=load_yaml(os.path.join(run, "config.yaml")))
    history = checkpoint.parse_valid_history(os.path.join(run, "train.log"))
    loss = {e: checkpoint._loss_for_epoch(history, e) for e in range(1, RECIPE_EPOCHS + 1)}
    expected = sorted(loss, key=lambda e: (math.isnan(loss[e]), loss[e]))[:2]
    picked = [checkpoint._ckpt_epoch(p) for p in checkpoint.pick_checkpoints(cfg.inference)]
    if picked != expected:
        raise RuntimeError(f"averaged epochs {picked}, parse_valid_history predicts {expected}")
    reset_counts(fa)
    t0 = time.perf_counter()
    results = infer.infer(cfg, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1 = counts(fa)[0]
    if k1 != ENC_LAYERS or results[0][1] <= 0:
        raise RuntimeError(f"averaged attention decode: {results}, K1 {k1}")
    log(f"infer model_avg=true avg_num=2 (N-best by valid loss {loss}): epochs {picked}, "
        f"mode=attention beam {BEAM} on the {N_WAVE_VALID} raw-wave valid utterances in "
        f"{secs:.2f} s incl. loading: error count {results[0][0]}/{results[0][1]}, "
        f"K1 launches {k1} [{name}]")
    return k1


def check_beam_parity(task, dev, name):
    """Phase e: the cached attention beam of 2 utterances in fp32 on the
    card (encoder through K1) and on the CPU (plain path), with the decoder
    projection scaled by 8 in both so that the posteriors are peaked."""
    from liteasr_tpu_torch import decode

    data = task.dataset("test").data[:2]
    T = max(a.xlen for a in data)
    xs = np.zeros((2, T, FEAT), np.float32)
    for i, a in enumerate(data):
        xs[i, :a.xlen] = a.x
    xs, xlens = torch.from_numpy(xs), torch.tensor([a.xlen for a in data])
    outs = []
    for device in (dev, torch.device("cpu")):
        model = build_model(torch.float32, device)
        with torch.no_grad():
            model.decoder.linear_out.weight.mul_(8.0)
            model.decoder.linear_out.bias.mul_(8.0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            h_enc, enc_mask = model.encode(xs.to(device), xlens.to(device))
            hyp, lens, scores = decode.attention_beam_search(model, h_enc, enc_mask, BEAM)
        outs.append((hyp.cpu(), lens.cpu(), scores.cpu(), time.perf_counter() - t0))
    (g_hyp, g_len, g_sc, g_s), (c_hyp, c_len, c_sc, c_s) = outs
    s_err = (g_sc - c_sc).abs().max().item()
    same = torch.equal(g_hyp, c_hyp) and torch.equal(g_len, c_len)
    log(f"attention beam parity fp32 card vs CPU (2 utts, L={g_hyp.shape[1]}, beam "
        f"{BEAM}): hypotheses {'identical' if same else 'DIFFER'} (lens "
        f"{g_len.tolist()}), best scores {g_sc.tolist()} vs {c_sc.tolist()}, max abs "
        f"diff {s_err:.3g} (bound {BEAM_SCORE_TOL}); {g_s:.2f} s card, {c_s:.2f} s CPU "
        f"[{name}]")
    if not same or not s_err <= BEAM_SCORE_TOL or not bool(torch.isfinite(g_sc).all()):
        raise RuntimeError("the attention beam differs between the card and the CPU")


def check_remat(dev, name):
    """Phase f: remat on against off at bench.py's point: one fp32 step
    (dropout 0.1, same seed and weights) held to the train-parity rule,
    then the bf16 micro-step's time and peak memory, off and on."""
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss

    batch, B = bench_batch(dev)
    crit = HybridCTCLoss(DotDict(vocab_size=VOCAB, padding_idx=-1, smoothing=0.1,
                                 ctc_weight=0.3))
    res = []
    for remat in (True, False):
        model = build_model(torch.float32, dev, dropout_rate=0.1, remat=remat)
        torch.manual_seed(SEED)
        model.seed_dropout(SEED)
        loss, _ = crit(model, batch, train=True)
        loss.backward()
        res.append((loss.item(), {n: p.grad.detach().clone() for n, p in
                                  model.named_parameters()}))
        del model, loss
    what = grad_agreement(res[0][0], res[0][1], res[1][0], res[1][1])
    log(f"remat parity fp32 (B={B}, T=800, U=48, dropout 0.1), remat on vs off: "
        f"{what} [{name}]")
    del res
    for remat in (False, True):
        gc.collect()  # the trainers of earlier phases are reference cycles
        torch.cuda.empty_cache()
        step, _ = bench_step(dev, remat=remat)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) / 5)
        if not bool(torch.isfinite(loss)):
            raise RuntimeError("non-finite loss in the remat timing")
        log(f"train step bf16 at bench.py's point, remat {'on' if remat else 'off'}: "
            f"median {statistics.median(reps) * 1e3:.2f} ms/micro-step (of 3 x 5), "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{name}]")
        del step
        torch.cuda.empty_cache()


# ------------------------------------------- the hard-corpus recipe (hc)


def results_rows(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


def check_eval(fa, report, out, results, n_test, name):
    """eval_hard u2's three dumps (``index\\tref\\thyp``, one line an
    utterance), its three CI rows in ``results``, and its K1 launches: 24 a
    rescore batch (12 encoder, 6 + 6 decoder), 12 a greedy batch."""
    batches = -(-n_test // 32)
    k1 = counts(fa)[0]
    expect = batches * (2 * (ENC_LAYERS + 2 * DEC_LAYERS) + ENC_LAYERS)
    if k1 != expect:
        raise RuntimeError(f"eval_hard: K1 {k1} launches, not {expect} ({batches} "
                           "batches a decode)")
    for dump in report["decodes"]:
        with open(os.path.join(out, f"{dump}.tsv")) as f:
            lines = [ln.rstrip("\n").split("\t") for ln in f]
        if len(lines) != n_test or any(len(p) != 3 or p[0] != str(i)
                                       for i, p in enumerate(lines)):
            raise RuntimeError(f"{dump}.tsv: not {n_test} index/ref/hyp lines")
    rows = [r for r in results_rows(results, "score_ci") if r["dump"].startswith(out)]
    if len(rows) != 3 or [r.get("vs") for r in rows] != [
            None, f"{out}/avg_ctc_greedy.tsv", f"{out}/last_rescore.tsv"]:
        raise RuntimeError(f"eval_hard's CI rows in {results}: {rows}")
    greedy, last = rows[1], rows[2]
    for dump, rate, ci in (("avg_rescore", rows[0]["rate"], rows[0]["ci95"]),
                           ("avg_ctc_greedy", greedy["vs_rate"], greedy["vs_ci95"]),
                           ("last_rescore", last["vs_rate"], last["vs_ci95"])):
        log(f"eval {dump}: {100 * rate:.2f}% token error [{100 * ci[0]:.2f}, "
            f"{100 * ci[1]:.2f}] in {report['decodes'][dump]['seconds']:.2f} s "
            f"({batches} batches) [{name}]")
    log(f"eval rescore - greedy (avg, paired): {100 * greedy['diff']:+.2f} pp "
        f"[{100 * greedy['diff_ci95'][0]:+.2f}, {100 * greedy['diff_ci95'][1]:+.2f}], "
        f"p {greedy['p_two_sided']}; avg - last (rescore): {100 * last['diff']:+.2f} pp "
        f"[{100 * last['diff_ci95'][0]:+.2f}, {100 * last['diff_ci95'][1]:+.2f}]; "
        f"K1 {k1} launches ({batches} batches a decode) [{name}]")
    return rows, k1


def run_hard_corpus(fa, root, dev, name):
    """Phase hc: the hard-corpus recipe of liteasr_tpu_torch/tools at full
    width on a cut corpus. Returns the (K1, K1', K2) launches of the
    training run and of the eval."""
    from liteasr_tpu_torch.tools import eval_hard, run_hard, summarize_run

    corpus, run = os.path.join(root, "synth_hard"), os.path.join(root, "hard_u2_run")
    results = os.path.join(run, "results.jsonl")
    t0 = time.perf_counter()
    run_hard.ensure_corpus(corpus, HC_UTTS)
    render_s = time.perf_counter() - t0
    reset_counts(fa)
    t0 = time.perf_counter()
    trainer = run_hard.run("u2", run, HC_EPOCHS, HC_NOAM + [f"common.results_file={results}"],
                           corpus=corpus, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, lse, bwd = counts(fa)
    micro = HC_EPOCHS * len(trainer.task.dataset("train"))
    n_valid = HC_EPOCHS * len(trainer.valid_set)
    if (lse, bwd, fwd - lse) != (ENC_LAYERS * micro, ENC_LAYERS * micro,
                                 (ENC_LAYERS + 2 * DEC_LAYERS) * n_valid):
        raise RuntimeError(f"hc: K1' {lse}, K2 {bwd}, K1 {fwd - lse} launches for "
                           f"{micro} micro-batches and {n_valid} valid batches")
    losses = torch.stack(trainer._loss_accum).float().cpu() if trainer._loss_accum else None
    valid = [r["valid_loss"] for r in results_rows(results, "valid")]
    logged = [v for _, _, v in summarize_run.parse(os.path.join(run, "train.log"))[0]]
    if (len(valid) != HC_EPOCHS or not all(math.isfinite(v) for v in valid)
            or logged != [round(v, 2) for v in valid]):
        raise RuntimeError(f"hc: valid losses {valid}, train.log's {logged}")
    if losses is not None and not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"hc: training losses {losses.tolist()}")
    if not valid[-1] <= HC_MARGIN * valid[0]:
        raise RuntimeError(f"hc: the valid loss fell from {valid[0]:.3f} to {valid[-1]:.3f}, "
                           f"not below {HC_MARGIN} of the first")
    vocab = trainer.task.vocab_size
    log(f"hc: --hard corpus of {HC_UTTS} utterances (vocab {vocab}) rendered in "
        f"{render_s:.2f} s; run_hard u2 for {HC_EPOCHS} epochs ({micro} micro-batches, "
        f"{int(trainer.tx.count)} optimizer steps, {int(trainer.tx.notfinite_count)} skipped) "
        f"in {train_s:.2f} s, {HC_EPOCHS * HC_UTTS[0] / train_s:.1f} utt/s incl. validation "
        f"and checkpoints; valid loss {[round(v, 3) for v in valid]} (the last at most "
        f"{HC_MARGIN} of the first); K1' {lse}, K2 {bwd}, K1 {fwd - lse} [{name}]")
    del trainer
    gc.collect()
    reset_counts(fa)
    report = eval_hard.evaluate("u2", run, HC_EPOCHS, HC_AVG, device=dev)
    out = os.path.join(run, f"eval_ep{HC_EPOCHS}")
    _, k1 = check_eval(fa, report, out, results, HC_UTTS[2], name)
    return (fwd - lse, lse, bwd), k1


@contextlib.contextmanager
def plain_attention(fa):
    """Every attention call of ``nets.attention`` through K1's plain version
    on the card (a check of the kernels, never used by the package)."""
    from liteasr_tpu_torch.nets import attention

    kernel = attention.flash_attention

    def plain(q, k, v, *args, chunk=0, **kwargs):
        return fa.flash_attention_plain(q, k, v, *args, chunk=int(chunk), **kwargs)

    attention.flash_attention = plain
    try:
        yield
    finally:
        attention.flash_attention = kernel


def diagnose_last(fa, run, last, out, dev, name):
    """The last checkpoint's attention rescore beside eval_hard's (512, the
    kernels): at the training's padding (:data:`TRAIN_PAD_TIME`), and at 512
    through K1's plain version. Prints each rate and CI, the paired
    differences and the hypotheses that differ; rows in ``<diag>/score_ci.jsonl``."""
    from liteasr_tpu_torch.tools import eval_hard, score_ci

    diag = os.path.join(run, f"diagnose_ep{last}")
    rows = os.path.join(diag, "score_ci.jsonl")
    last_mode = ["inference.model_avg=false", "inference.mode=attention_rescore"]
    reset_counts(fa)
    pad = eval_hard.decode(run, last, f"last_rescore_pad{TRAIN_PAD_TIME}", last_mode, diag,
                           device=dev, pad=TRAIN_PAD_TIME)
    k1 = counts(fa)[0]
    with plain_attention(fa):
        plain = eval_hard.decode(run, last, "last_rescore_plain", last_mode, diag, device=dev)
    if counts(fa)[0] != k1 or not k1:
        raise RuntimeError(f"diagnose: K1 {k1} launches at pad {TRAIN_PAD_TIME}, "
                           f"{counts(fa)[0] - k1} under plain_attention")
    ref = os.path.join(out, "last_rescore.tsv")
    for dump, secs in ((f"last_rescore_pad{TRAIN_PAD_TIME}", pad["seconds"]),
                       ("last_rescore_plain", plain["seconds"])):
        path = os.path.join(diag, f"{dump}.tsv")
        row = score_ci.score(path, vs=ref, json_out=rows)
        with open(path) as f, open(ref) as g:
            differ = sum(a != b for a, b in zip(f, g))
        log(f"diagnose {dump}: {100 * row['rate']:.2f}% [{100 * row['ci95'][0]:.2f}, "
            f"{100 * row['ci95'][1]:.2f}] in {secs:.2f} s; minus eval_hard's last_rescore "
            f"(512, kernels) {100 * row['diff']:+.2f} pp [{100 * row['diff_ci95'][0]:+.2f}, "
            f"{100 * row['diff_ci95'][1]:+.2f}], p {row['p_two_sided']}; {differ} of "
            f"{row['n_utts']} hypotheses differ [{name}]")
    return diag


def run_convergence(fa, dev, name, legs=CONVERGENCE_LEGS, keep=None,
                    deadline_s=CONVERGENCE_DEADLINE_S):
    """--convergence: run_hard u2 on the full hard corpus in ``legs``, then
    eval_hard u2 at the last epoch and :func:`diagnose_last`; prints the
    per-epoch rows and the eval table, copies the run's logs, rows and dumps
    to ``keep`` (if given) and raises if a bound of
    :data:`CONVERGENCE_BOUNDS` is missed. No epoch starts after
    ``deadline_s`` of the script's clock less the eval's and an epoch's
    seconds; the eval then runs at the last saved epoch, and the run fails.
    Refuses a run directory that already holds a train state."""
    import shutil

    from liteasr_tpu_torch.tools import eval_hard, run_hard, summarize_run

    run = run_hard.default_run_dir("u2")
    results = os.path.join(run, "results.jsonl")
    if os.path.exists(os.path.join(run, "ckpts", "train_state.pt")):
        raise RuntimeError(f"{run} holds a run already: move it away, so that the legs "
                           "train and are judged on this call's epochs only")
    t0 = time.perf_counter()
    # in a process of its own, so that the training's process starts clean
    subprocess.run([sys.executable, "-c", "from liteasr_tpu_torch.tools import run_hard; "
                    "run_hard.ensure_corpus()"], cwd=REPO, check=True, timeout=900)
    log(f"convergence: corpus {run_hard.CORPUS} ready in {time.perf_counter() - t0:.2f} s "
        f"({run_hard.CORPUS_UTTS} utterances) [{name}]")
    extra = ["common.resume=auto", f"common.results_file={results}"]
    start_epoch = start_step = 0
    for end in legs:
        reset_counts(fa)
        budget = (deadline_s - CONVERGENCE_EVAL_S - CONVERGENCE_EPOCH_S
                  - (time.time() - START))
        if budget <= 0:
            break
        t0 = time.perf_counter()
        trainer = run_hard.run("u2", run, end, extra, device=dev, timeout_s=budget)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        fwd, lse, bwd = counts(fa)
        epochs, micro = trainer.epoch - start_epoch, trainer.step - start_step
        n_valid = epochs * len(trainer.valid_set)
        if (lse, bwd, fwd - lse) != (ENC_LAYERS * micro, ENC_LAYERS * micro,
                                     (ENC_LAYERS + 2 * DEC_LAYERS) * n_valid):
            raise RuntimeError(f"leg to {end}: K1' {lse}, K2 {bwd}, K1 {fwd - lse} "
                               f"launches for {micro} micro-batches, {n_valid} valid batches")
        log(f"convergence leg: epochs {start_epoch + 1}-{trainer.epoch} "
            f"({f'resumed after epoch {start_epoch}' if start_epoch else 'fresh'}), "
            f"{micro} micro-batches, {int(trainer.tx.count)} optimizer steps so far "
            f"({int(trainer.tx.notfinite_count)} skipped) in {secs:.2f} s, "
            f"{secs / max(epochs, 1):.2f} s an epoch; per epoch K1' {lse // max(epochs, 1)}, "
            f"K2 {bwd // max(epochs, 1)}, K1 {(fwd - lse) // max(epochs, 1)} (valid) [{name}]")
        start_epoch, start_step = trainer.epoch, trainer.step
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        if start_epoch < end:
            log(f"convergence leg to epoch {end}: stopped by the deadline after epoch "
                f"{start_epoch} [{name}]")
            break
    gc.collect()
    torch.cuda.empty_cache()
    if not start_epoch:
        raise RuntimeError(f"convergence: no epoch fits before the deadline of {deadline_s} s")
    with open(os.path.join(run, "ckpts", "train_state.pt.meta")) as f:
        last = int(json.load(f)["epoch"])  # the last epoch whose save completed
    meta = results_rows(results, "run_meta")
    valid = results_rows(results, "valid")
    if [r["epoch"] for r in valid][:last] != list(range(1, last + 1)):
        raise RuntimeError(f"valid rows for epochs {[r['epoch'] for r in valid]}")
    log("convergence epochs: | epoch | iter | valid loss | loss_attn | loss_ctc | s |")
    prev = meta[0]["ts"]
    for r in valid:
        after_resume = [m["ts"] for m in meta[1:] if prev < m["ts"] < r["ts"]]
        t = r["ts"] - (after_resume[-1] if after_resume else prev)
        log(f"| {r['epoch']} | {r['iter']} | {r['valid_loss']:.4f} | {r.get('loss_attn')} | "
            f"{r.get('loss_ctc')} | {t:.1f}{' (after a resume)' if after_resume else ''} |")
        prev = r["ts"]
    thr = summarize_run.parse(os.path.join(run, "train.log"))[1]
    if thr:
        log(f"convergence throughput: median {statistics.median(thr):.1f} utt/s over "
            f"{len(thr)} report windows, {min(thr):.1f}-{max(thr):.1f} [{name}]")
    reset_counts(fa)
    report = eval_hard.evaluate("u2", run, last, min(CONVERGENCE_AVG, last), device=dev)
    out = os.path.join(run, f"eval_ep{last}")
    rows, _ = check_eval(fa, report, out, results, run_hard.CORPUS_UTTS[2], name)
    diag = diagnose_last(fa, run, last, out, dev, name)
    if keep:
        os.makedirs(keep, exist_ok=True)
        for path in [os.path.join(run, f) for f in ("train.log", "results.jsonl",
                                                   "config.yaml", "infer.log")] + [
                os.path.join(d, f) for d in (out, diag) for f in os.listdir(d)]:
            if os.path.isfile(path):
                shutil.copy(path, keep)
    last_valid, last_rescore = valid[last - 1]["valid_loss"], rows[2]["vs_rate"]
    beats = rows[1]["diff_ci95"][1] < 0
    ok = (last == legs[-1] and last_valid <= CONVERGENCE_BOUNDS["valid_loss"]
          and last_rescore <= CONVERGENCE_BOUNDS["last_rescore"] and beats)
    log(f"convergence bounds ({'held' if ok else 'MISSED'}): valid loss at epoch "
        f"{last} of {legs[-1]} {last_valid:.4f} (at most {CONVERGENCE_BOUNDS['valid_loss']}), "
        f"last-checkpoint rescore {100 * last_rescore:.2f}% (at most "
        f"{100 * CONVERGENCE_BOUNDS['last_rescore']:.1f}%), rescore - greedy CI upper "
        f"{100 * rows[1]['diff_ci95'][1]:+.2f} pp (below 0: {beats}) [{name}]")
    if not ok:
        raise RuntimeError("a convergence bound was missed")


# ------------------------------------------------- the transducer (g-j)


def build_td_model(dtype, device, enc_layers=TD_ENC_LAYERS, lstm_layers=TD_LSTM_LAYERS,
                   dropout_rate=0.0):
    """The my_transducer preset at full width, random weights from SEED."""
    from liteasr_tpu_torch.models.transducer import Transducer

    gen = torch.Generator().manual_seed(SEED)
    rates = {k: dropout_rate for k in (
        "enc_dropout_rate", "enc_pos_dropout_rate", "enc_attn_dropout_rate",
        "enc_ff_dropout_rate", "dec_dropout_rate")}
    return Transducer(input_dim=FEAT, vocab_size=VOCAB, joint_dim=TD_JOINT, enc_dim=DIM,
                      enc_ff_dim=2048, enc_attn_heads=HEADS, enc_layers=enc_layers,
                      dec_dim=DIM, dec_units=TD_UNITS, dec_layers=lstm_layers,
                      dtype=dtype, device=device, generator=gen, **rates)


def infer_td_checkpoint(fa, run, mode, dev, name):
    """infer.infer of the transducer run's last checkpoint in ``mode``;
    returns the K1 launches."""
    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    cfg = compose([f"inference.ckpt_name={TRAIN_EPOCHS}", "inference.model_avg=false",
                   f"inference.batch_size={N_VALID}", f"inference.beam_size={BEAM}",
                   f"inference.mode={mode}"],
                  base=load_yaml(os.path.join(run, "config.yaml")))
    reset_counts(fa)
    t0 = time.perf_counter()
    results = infer.infer(cfg, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1 = counts(fa)[0]
    if k1 != TD_ENC_LAYERS or results[0][1] <= 0:
        raise RuntimeError(f"decoding the transducer checkpoint ({mode}): {results}, K1 {k1}")
    log(f"transducer infer mode={mode} of model.ep.{TRAIN_EPOCHS}.pt on the {N_VALID} "
        f"valid utterances in {secs:.2f} s incl. loading: error count "
        f"{results[0][0]}/{results[0][1]} (2 epochs on random data), K1 launches {k1} [{name}]")
    return k1


def run_td_training(fa, root, dev, name):
    """Phase g: the transducer through train.main at full width, then
    infer.infer of its checkpoint in both modes. Returns the (K1, K1', K2)
    launches of the training run, the K1 launches of the two decodes and
    the run's (forward, backward) RNN-T DP launches: one forward a
    micro-batch and a valid batch, one backward a micro-batch."""
    from liteasr_tpu_torch import train

    run = os.path.join(root, "td_run")
    overrides = train_overrides("rnnt", root, run, TRAIN_EPOCHS)
    reset_counts(fa)
    reset_dp_counts()
    t0 = time.perf_counter()
    trainer = train.main(overrides, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fwd, lse, bwd = counts(fa)
    dp = dp_counts()
    micro = TRAIN_EPOCHS * len(trainer.task.dataset("train"))
    n_valid = TRAIN_EPOCHS * len(trainer.valid_set)
    losses = torch.stack(trainer._loss_accum).float().cpu()
    if (lse, bwd, fwd - lse) != (TD_ENC_LAYERS * micro, TD_ENC_LAYERS * micro,
                                 TD_ENC_LAYERS * n_valid):
        raise RuntimeError(f"transducer launches K1' {lse}, K2 {bwd}, K1 {fwd - lse} for "
                           f"{micro} micro-batches and {n_valid} valid batches")
    if dp != (micro + n_valid, micro):
        raise RuntimeError(f"RNN-T DP launches {dp} (forward, backward) for {micro} "
                           f"micro-batches and {n_valid} valid batches")
    if len(losses) != micro or not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"transducer training losses {losses.tolist()}")
    init = dict(build_td_model(torch.bfloat16, "cpu").named_parameters())
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach().cpu(), init[n])]  # same seed as train.main
    lstm = [n for n in init if ".cell." in n]
    if (int(trainer.tx.count) < 1 or len(moved) < len(init) // 2
            or not set(lstm) <= set(moved)):
        raise RuntimeError(f"{int(trainer.tx.count)} steps applied, {len(moved)} "
                           f"parameters moved, LSTM leaves not moved: "
                           f"{sorted(set(lstm) - set(moved))}")
    with open(os.path.join(run, "train.log")) as f:
        valid_lines = [ln for ln in f if "valid loss:" in ln]
    if len(valid_lines) != TRAIN_EPOCHS:
        raise RuntimeError(f"{len(valid_lines)} 'valid loss:' lines")
    if not os.path.isfile(os.path.join(run, "ckpts", f"model.ep.{TRAIN_EPOCHS}.pt")):
        raise RuntimeError(f"model.ep.{TRAIN_EPOCHS}.pt was not written")
    log(f"transducer train: {micro} micro-batches of <= {TRAIN_BATCH} utts in "
        f"{TRAIN_EPOCHS} epochs, {int(trainer.tx.count)} optimizer steps "
        f"({int(trainer.tx.notfinite_count)} skipped), {secs:.2f} s incl. validation and "
        f"checkpoints; losses {[round(x, 3) for x in losses.tolist()]}; K1' {lse}, K2 "
        f"{bwd}, K1 {fwd - lse} launches; RNN-T DP launches {dp[0]} forward + {dp[1]} "
        f"backward; {len(moved)} of {len(init)} parameter leaves "
        f"moved, the {len(lstm)} LSTM leaves among them; "
        f"{valid_lines[-1].split(' - ')[-1].strip()} [{name}]")
    del trainer
    dec = [infer_td_checkpoint(fa, run, mode, dev, name)
           for mode in ("transducer_greedy", "transducer_beam_search")]
    return (fwd - lse, lse, bwd), sum(dec), dp


def td_bench_step(dev, shard=False):
    """The full-width bf16 transducer micro-step (dropout 0.1, RNN-T loss,
    Noam Adam, clip 5, accum 2) on bench_batch; returns (step, model,
    batch, B). ``shard``: on this rank's tp/sp shard of the model (z7)."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.rnnt import RNNTLoss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam
    from liteasr_tpu_torch.optims.noam import noam_schedule
    from liteasr_tpu_torch.parallel import sharding

    torch.manual_seed(SEED)
    model = build_td_model(torch.bfloat16, dev, dropout_rate=0.1)
    if shard:
        sharding.shard_model(model, parallel.layout())
    crit = RNNTLoss(DotDict(blank_id=0))
    params = list(model.parameters())
    tx = FusedAdam(params, noam_schedule(256, 1.0, 25000), 0.9, 0.98, 1e-9,
                   clip=5.0, accum=ACCUM, sharded=sharding.sharded_parameters(model))
    batch, B = bench_batch(dev)

    def step():
        loss, _ = crit(model, batch, train=True)
        loss.backward()
        tx.update([p.grad for p in params])
        for p in params:
            p.grad = None
        return loss

    return step, model, batch, B


def host_time_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``fn`` over ``reps`` calls, each ended by a
    synchronize (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_td_step(dev, name):
    """Phase h: the transducer micro-step at bench.py's point: median of 5
    repetitions of 4 micro-steps, utt/s and peak memory, one RNN-T DP
    launch each way a micro-step; then the step's parts that were predicted
    to take its time, each timed alone (forward and backward) on the same
    shapes: the joint's output GEMM, the lattice's fp32 lse and gathers, and
    the DP's kernels; then :func:`check_rnnt_dp`. Returns its numbers and
    the micro-steps' DP launches."""
    from liteasr_tpu_torch.ops.rnnt import lattice_log_probs, lattice_nll

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, model, batch, B = td_bench_step(dev)
    reset_dp_counts()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            loss = step()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 4)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite transducer loss in the timed steps")
    step_dp = dp_counts()
    if step_dp != (23, 23):
        raise RuntimeError(f"RNN-T DP launches {step_dp} (forward, backward) in 23 micro-steps")
    med = statistics.median(reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        lattice = model(batch["xs"], batch["xlens"], batch["ys"], batch["ylens"])
    B_, T_, U1, V = lattice.shape
    targets = model.get_target(batch["ys"], batch["ylens"])
    pred_len = model.get_pred_len(batch["xlens"])
    leaf = lattice.requires_grad_()
    lp_blank, lp_emit = (x.detach().requires_grad_()
                         for x in lattice_log_probs(lattice, targets))
    z = (torch.rand((B_, T_, U1, TD_JOINT), device=dev) * 2 - 1).to(
        torch.bfloat16).requires_grad_()  # the joint's tanh layer
    grad_out = torch.randn_like(lattice)

    def gemm_part():
        model.lin_jnt(z).backward(grad_out)
        z.grad = None

    def lse_part():
        a, b = lattice_log_probs(leaf, targets)
        (a.sum() + b.sum()).backward()
        leaf.grad = None

    def dp_part():
        lattice_nll(lp_blank, lp_emit, pred_len, batch["ylens"]).sum().backward()
        lp_blank.grad = lp_emit.grad = None

    gemm_ms, lse_ms, dp_ms = (host_time_ms(f) for f in (gemm_part, lse_part, dp_part))
    gemm_flops = 3 * 2.0 * B_ * T_ * U1 * TD_JOINT * V
    log(f"transducer train step at bench.py's point (B={B}, T=800 -> T'={T_}, U={U1 - 1}, "
        f"V={V}, bf16, accum {ACCUM}): median {med * 1e3:.2f} ms/micro-step (best "
        f"{min(reps) * 1e3:.2f}; 5 x 4 steps), {B / med:.2f} utt/s, peak memory "
        f"{peak:.2f} GiB; parts timed alone, fwd+bwd: the joint's output GEMM "
        f"{gemm_ms:.2f} ms ({gemm_flops / 1e12:.2f} TFLOP, "
        f"{gemm_flops / gemm_ms / 1e9:.0f} TFLOP/s), the lattice's fp32 lse and gathers "
        f"{lse_ms:.2f} ms, the DP (its two kernels) {dp_ms:.2f} ms; RNN-T DP launches in "
        f"the 23 micro-steps {step_dp[0]} forward + {step_dp[1]} backward [{name}]")
    rep = check_rnnt_dp(lp_blank.detach(), lp_emit.detach(), pred_len, batch["ylens"], name)
    return dict(rep, step_launches=step_dp)


# one step of the DP kernels' chain: a barrier, a shared-memory read of
# the neighbour and a logadd (expf, log1pf), ~90 cycles at 1.755 GHz
DP_STEP_NS = 50.0


def check_rnnt_dp(lp_blank, lp_emit, in_lens, lab_lens, name):
    """Phase h's DP: the kernels (``csrc/rnnt_dp.cu``) and the plain loop
    over T', both in fp32 on the phase's planes, against the plain loop in
    fp64 on the card, under ``tests/test_torch_rnnt_gpu.py``'s limits: the
    losses to 2e-5 of themselves; both gradients of a weighted sum (one row
    at weight 0) of the kernels to delta = 4 sqrt(T' + U) ulp(logZ) of each
    gradient over a floor of 1e-6 (a gradient is exp(alpha + lp + beta -
    logZ): an error delta in its exponent is one of delta of itself), the
    loop's to delta absolute (its emit gradient leaves autograd through the
    differences of a cumulative sum); the kernels' gradient on the weight-0
    row exactly 0, and one launch each way. Then each side's forward and
    backward timed alone (the kernels by CUDA events, the loop by the host
    clock, which paces it) beside the kernels' bound: the larger of the two
    planes' bytes at 3.35 TB/s and T' + U steps of DP_STEP_NS. Returns the
    numbers of the kernels line's ``rnnt_dp`` entry."""
    from liteasr_tpu_torch.ops import rnnt

    B, T, U1 = lp_blank.shape
    in_lens, lab_lens = in_lens.long(), lab_lens.long()
    weights = torch.linspace(0.5, 1.5, B, device=lp_blank.device)
    weights[-1] = 0.0

    def run(fn, dtype=torch.float32):
        b, e = (x.to(dtype, copy=True).requires_grad_() for x in (lp_blank, lp_emit))
        loss = fn(b, e, in_lens, lab_lens)
        (loss * weights.to(dtype)).sum().backward()
        return loss.detach().double(), b.grad.double(), e.grad.double()

    reset_dp_counts()
    got = run(rnnt.lattice_nll)
    if dp_counts() != (1, 1):
        raise RuntimeError(f"the DP launched {dp_counts()} kernels (forward, backward), "
                           "not one each way")
    plain = run(rnnt._lattice_nll)
    ref = run(rnnt._lattice_nll, torch.float64)
    delta = 4.0 * (T + U1 - 1) ** 0.5 * float(np.spacing(np.float32(ref[0].abs().max().item())))

    def gaps(side, rtol, atol):
        """The loss's largest relative gap; each gradient's largest absolute
        gap and its largest share of the limit (1 is the limit)."""
        out = [((side[0] - ref[0]).abs() / ref[0].abs()).max().item()]
        for x, r in zip(side[1:], ref[1:]):
            d = (x - r).abs()
            out += [d.max().item(), (d / (atol + rtol * r.abs())).max().item()]
        return out

    k_gaps, p_gaps = gaps(got, delta, 1e-6), gaps(plain, 0.0, delta)
    for side, (loss_gap, _, b_share, _, e_share) in (("kernels", k_gaps), ("loop", p_gaps)):
        if loss_gap > 2e-5 or max(b_share, e_share) > 1.0:
            raise RuntimeError(f"the DP's {side} against the fp64 loop: loss {loss_gap:.3g} "
                               f"(limit 2e-5), gradients at {b_share:.3g} and {e_share:.3g} "
                               f"of the limit (delta {delta:.3g})")
    if (got[1][-1] != 0).any() or (got[2][-1] != 0).any():
        raise RuntimeError("the DP kernels gave a weight-0 row a gradient")

    loss, alpha = rnnt._launch_fwd(lp_blank, lp_emit, in_lens, lab_lens)
    k_fwd = cuda_time_ms(lambda: rnnt._launch_fwd(lp_blank, lp_emit, in_lens, lab_lens))
    k_bwd = cuda_time_ms(lambda: rnnt._launch_bwd(lp_blank, lp_emit, in_lens, lab_lens,
                                                  alpha, loss, weights))
    b, e = (x.clone().requires_grad_() for x in (lp_blank, lp_emit))
    p_fwd = host_time_ms(lambda: rnnt._lattice_nll(b, e, in_lens, lab_lens))
    p_all = host_time_ms(lambda: (rnnt._lattice_nll(b, e, in_lens, lab_lens) * weights)
                         .sum().backward())
    byte_ms = 2 * B * T * U1 * 4 / 3.35e12 * 1e3
    chain_ms = (T + U1 - 1) * DP_STEP_NS * 1e-6
    p_rel = gaps(plain, delta, 1e-6)  # the loop under the kernels' limit: a reading only
    log(f"RNN-T DP at B={B}, T'={T}, U+1={U1} against the fp64 loop (delta {delta:.3g}): "
        f"kernels loss {k_gaps[0]:.3g} relative, d lp_blank {k_gaps[1]:.3g} abs at "
        f"{k_gaps[2]:.3g} of their limit (delta of each gradient + 1e-6), d lp_emit "
        f"{k_gaps[3]:.3g} at {k_gaps[4]:.3g}, the weight-0 row's gradient 0, 1 launch each "
        f"way; fp32 loop loss {p_gaps[0]:.3g}, d lp_blank {p_gaps[1]:.3g} abs, d lp_emit "
        f"{p_gaps[3]:.3g} abs (limit delta absolute; at {p_rel[2]:.3g} and {p_rel[4]:.3g} of "
        f"the kernels' limit); kernel fwd {k_fwd:.4f} ms, bwd "
        f"{k_bwd:.4f} ms (CUDA events); plain loop fwd {p_fwd:.2f} ms, bwd "
        f"{p_all - p_fwd:.2f} ms (host clock); bound {max(byte_ms, chain_ms):.4f} ms a "
        f"direction (bytes {byte_ms:.4f}, chain of {T + U1 - 1} steps at {DP_STEP_NS:.0f} "
        f"ns {chain_ms:.4f}) [{name}]")
    return {"max_abs_err": max(k_gaps[1], k_gaps[3]), "loss_rel_err": k_gaps[0],
            "limit_share": max(k_gaps[2], k_gaps[4]), "delta": delta,
            "plain_max_abs_err": max(p_gaps[1], p_gaps[3]), "ms": k_fwd, "bwd_ms": k_bwd,
            "plain_ms": p_fwd, "plain_bwd_ms": p_all - p_fwd,
            "bound_ms": max(byte_ms, chain_ms),
            "bound_by": "bytes" if byte_ms > chain_ms else "chain"}


def run_td_decode(fa, task, dev, name):
    """Phase i: the test corpus decoded with the full-width transducer
    (random bf16 weights from SEED) through infer_dataset, greedy and the
    beam (K=BEAM, E=5): a warm-up batch, then the timed pass with the counts
    reset. Returns the K1 launches and {mode: s/batch}."""
    from types import SimpleNamespace

    from liteasr_tpu_torch import decode
    from liteasr_tpu_torch.infer import infer_dataset

    dataset = task.dataset("test")
    model = build_td_model(torch.bfloat16, dev)
    n_batches = -(-len(dataset.data) // BATCH)
    audio_s = sum(a.xlen for a in dataset.data) * FRAME_S
    warm = SimpleNamespace(data=dataset.data[:BATCH], feat_dim=dataset.feat_dim)
    total, per_batch = 0, {}
    for mode in ("transducer_greedy", "transducer_beam_search"):
        cfg = {"batch_size": BATCH, "beam_size": BEAM, "mode": mode,
               "expansions_per_frame": 5}
        infer_dataset(task, model, warm, cfg, dev, PAD_TIME, verbose=False)
        torch.cuda.synchronize()
        reset_counts(fa)
        decode_fn = getattr(decode, mode)
        decode_s = []

        def timed(*args, **kwargs):  # the decode alone, without the scoring
            t1 = time.perf_counter()
            out = decode_fn(*args, **kwargs)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t1)
            return out

        setattr(decode, mode, timed)
        try:
            t0 = time.perf_counter()
            pairs = []
            err, length = infer_dataset(task, model, dataset, cfg, dev, PAD_TIME,
                                        verbose=False, collect=pairs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            setattr(decode, mode, decode_fn)
        launches = fa.flash_attention.launches
        if launches != TD_ENC_LAYERS * n_batches:
            raise RuntimeError(f"K1 launched {launches} times for {n_batches} batches "
                               f"in {mode}, expected {TD_ENC_LAYERS} per batch")
        if len(pairs) != len(dataset.data) or length <= 0:
            raise RuntimeError("infer_dataset did not score every utterance")
        n_tok = sum(len(hyp.split()) for _, hyp in pairs)
        dec = sum(decode_s)
        log(f"transducer decode {mode}: {n_batches} batches of <= {BATCH} utts (longest "
            f"padded to 1600 frames), {secs / n_batches:.4f} s/batch through "
            f"infer_dataset, of which the decode {dec / n_batches:.4f} s/batch and the "
            f"host's scoring the rest; {len(pairs) / secs:.2f} utt/s, RTF "
            f"{secs / audio_s:.5f} (decode alone {len(pairs) / dec:.2f} utt/s, RTF "
            f"{dec / audio_s:.5f}); K1 launches {launches} ({TD_ENC_LAYERS}/batch), "
            f"{n_tok} tokens emitted, error count {err}/{length} (random weights) [{name}]")
        total += launches
        per_batch[mode] = secs / n_batches
    return total, per_batch


def check_td_parity(task, dev, name):
    """Phase j, in fp32 (TF32 off): one transducer train step (full width, 2
    encoder and 1 LSTM layer, dropout 0) on the card, held to the
    train-parity rule against the same step on the CPU in fp64; then greedy
    and the beam (K=BEAM, E=5) of 2 utterances with the full preset and
    lin_jnt scaled by 8 (peaked posteriors) on the card and the CPU:
    identical hypotheses, beam scores within BEAM_SCORE_TOL."""
    from liteasr_tpu_torch import decode
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.rnnt import RNNTLoss
    from liteasr_tpu_torch.trainer import to_device

    rng = np.random.default_rng(SEED + 5)
    B, T, U = 4, 400, 24
    batch = {"xs": rng.normal(size=(B, T, FEAT)).astype(np.float32),
             "xlens": np.array([T, 350, 280, 200], np.int32),
             "ys": rng.integers(1, VOCAB - 1, size=(B, U)).astype(np.int32),
             "ylens": np.array([U, 20, 16, 1], np.int32),
             "valid": np.ones(B, np.float32)}
    batch["ys"][np.arange(U)[None] >= batch["ylens"][:, None]] = -1
    crit = RNNTLoss(DotDict(blank_id=0))
    res = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                          (torch.device("cpu"), torch.float64)):
        model = build_td_model(dtype, device, enc_layers=2, lstm_layers=1).to(dtype)
        b = to_device(batch, device)
        b["xs"] = b["xs"].to(dtype)
        loss, _ = crit(model, b, train=True)
        loss.backward()
        res.append((loss.item(), {n: p.grad.double().cpu()
                                  for n, p in model.named_parameters()}))
    with torch.no_grad():  # the bf16 model of the same weights, measured only
        lattice64 = model(b["xs"], b["xlens"], b["ys"], b["ylens"])
        bf16 = build_td_model(torch.bfloat16, dev, enc_layers=2, lstm_layers=1)
        b16 = to_device(batch, dev)
        lattice16 = bf16(b16["xs"], b16["xlens"], b16["ys"], b16["ylens"]).double().cpu()
        loss16 = crit(bf16, b16, train=False)[0].item()
    lat_err = ((lattice16 - lattice64).abs().max() / lattice64.abs().max()).item()
    del lattice16, lattice64, bf16
    # the reference is the CPU in fp64: the CPU's fp32 subsampling-conv
    # gradients lie up to 4.2e-3 of their max off it, the card's 1.6e-4
    # (NVIDIA H100 80GB HBM3, 700 W); the CPU's fp32 step is printed beside
    what = grad_agreement(res[0][0], res[0][1], res[2][0], res[2][1])
    cpu32 = max(((res[1][1][n] - g).abs().max() / g.abs().max()).item()
                for n, g in res[2][1].items() if not n.endswith(".linear_k.bias"))
    log(f"transducer train parity fp32 card vs CPU fp64 (2 encoder + 1 LSTM layers, B={B}, "
        f"T={T}, U={U}): {what}; the CPU's fp32 step against the same reference: worst "
        f"leaf {cpu32:.3g} of its max; the bf16 model on the card (measured, not held): "
        f"loss {loss16:.4f} (rel {abs(loss16 - res[2][0]) / abs(res[2][0]):.3g}), "
        f"lattice max abs diff {lat_err:.3g} of the lattice's max [{name}]")

    # the first 600 and 480 frames of two test utterances (T' = 149 and 119),
    # so that the CPU's beam stays short
    cut = (600, 480)
    xs = np.zeros((2, cut[0], FEAT), np.float32)
    for i, (a, n) in enumerate(zip(task.dataset("test").data, cut)):
        xs[i, :n] = a.x[:n]
    xs, xlens = torch.from_numpy(xs), torch.tensor(cut)
    outs = []
    for device in (dev, torch.device("cpu")):
        model = build_td_model(torch.float32, device)
        with torch.no_grad():
            model.lin_jnt.weight.mul_(8.0)
            model.lin_jnt.bias.mul_(8.0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            h_enc, _ = model.encode(xs.to(device), xlens.to(device))
            enc_lens = model.get_pred_len(xlens.to(device))
            g_tok, g_len = decode.transducer_greedy_search(model, h_enc, enc_lens)
            tok, lens, scores = decode.transducer_beam(model, h_enc, enc_lens, BEAM, 5)
        outs.append([x.cpu() for x in (g_tok, g_len, tok, lens, scores)]
                    + [time.perf_counter() - t0])
    (gg_tok, gg_len, gb_tok, gb_len, g_sc, g_s), (cg_tok, cg_len, cb_tok, cb_len, c_sc,
                                                  c_s) = outs
    same_greedy = torch.equal(gg_tok, cg_tok) and torch.equal(gg_len, cg_len)
    same_beam = torch.equal(gb_tok, cb_tok) and torch.equal(gb_len, cb_len)
    s_err = (g_sc - c_sc).abs().max().item()
    log(f"transducer decode parity fp32 card vs CPU (2 utts of {list(cut)} frames, "
        f"lin_jnt x8): greedy {'identical' if same_greedy else 'DIFFER'} (lens "
        f"{gg_len.tolist()}), beam {BEAM}/E=5 {'identical' if same_beam else 'DIFFER'} "
        f"(lens {gb_len.tolist()}), best scores {g_sc.tolist()} vs {c_sc.tolist()}, max "
        f"abs diff {s_err:.3g} (bound {BEAM_SCORE_TOL}); {g_s:.2f} s card, {c_s:.2f} s "
        f"CPU [{name}]")
    if (not same_greedy or not same_beam or not s_err <= BEAM_SCORE_TOL
            or not bool(torch.isfinite(g_sc).all())):
        raise RuntimeError("transducer decoding differs between the card and the CPU")


# ------------------------------------------------------ streaming U2 (k-n)


def check_chunk_kernels(fa, dev, name):
    """Phase k: K1' and K2 with each chunk width of CHUNKS and none at the
    training shape, fp32 and bf16, against the plain versions; the bf16
    calls timed beside their bounds (the plain version at STATIC_CHUNK).
    Then K1 with chunk STATIC_CHUNK at the encoder decode shape. Returns
    the bf16 errors, times and bounds by width."""
    gen = torch.Generator().manual_seed(SEED + 6)
    scale = TRAIN_D ** -0.5
    rep = {"fwd_err": 0.0, "bwd_err": 0.0, "fwd_ms": {}, "fwd_bound_ms": {},
           "bwd_ms": {}, "bwd_bound_ms": {}}
    for dtype in (torch.float32, torch.bfloat16):
        x = train_slice_inputs(gen, dev, dtype)
        ins = [x[n] for n in ("q_u", "qv", "k", "v", "p")]
        kv, dout = x["kv_lens"], x["dout"]
        live = kv > 0
        ftol, gtol = KERNEL_TOL[dtype], GRAD_TOL[dtype]
        for chunk in (0,) + CHUNKS:
            def fwd(plain=False, chunk=chunk):
                f = fa.flash_attention_plain if plain else fa.flash_attention
                return f(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4],
                         scale=scale, return_lse=True, dropout_rate=TRAIN_RATE,
                         dropout_seed=TRAIN_SEED, chunk=chunk)

            def bwd(out, lse, plain=False, chunk=chunk):
                f = fa.flash_rel_attention_bwd_plain if plain else fa.flash_rel_attention_bwd
                return f(*ins, kv, out, lse, dout, scale, TRAIN_RATE, TRAIN_SEED, chunk)

            out, lse = fwd()
            ref_out, ref_lse = fwd(plain=True)
            out32 = out.float()
            grads, ref_grads = bwd(out32, lse), bwd(out32, ref_lse, plain=True)
            torch.cuda.synchronize()
            ferr = max((out.float() - ref_out.float()).abs().max().item(),
                       (lse[live] - ref_lse[live]).abs().max().item())
            ok = (within(out, ref_out, ftol) and within(lse[live], ref_lse[live], ftol)
                  and bool((lse[~live] == fa.NEG_INF).all()))
            gerr = 0.0
            for gname, g, r in zip(("dq_u", "dqv", "dk", "dv", "dp"), grads, ref_grads):
                g = g.to(dtype).float()  # what K3 hands back
                gerr = max(gerr, (g - r).abs().max().item())
                ok = ok and within(g, r, gtol) and (gname == "dp" or bool((g[5] == 0).all()))
            label = f"chunk {chunk}" if chunk else "no chunk"
            if not ok:
                raise RuntimeError(f"K1'/K2 {dtype} {label}: out/lse err {ferr}, grad err "
                                   f"{gerr} beyond {ftol}/{gtol} (or the dead row is not 0)")
            line = (f"K1'/K2 {str(dtype)[6:]} BH={TRAIN_BH} T'={TRAIN_T} D={TRAIN_D} "
                    f"dropout {TRAIN_RATE} {label}: out/lse err {ferr:.3g} grad err "
                    f"{gerr:.3g} (tol {ftol}/{gtol})")
            if dtype == torch.bfloat16:
                rep["fwd_err"] = max(rep["fwd_err"], ferr)
                rep["bwd_err"] = max(rep["bwd_err"], gerr)
                fwd_ms, bwd_ms = cuda_time_ms(fwd), cuda_time_ms(lambda: bwd(out32, lse))
                fb, fb_by = fwd_bound(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1],
                                      rel_p=ins[4], lse=True, chunk=chunk)
                bb, bb_by = bwd_bound(*ins, kv, out32, lse, dout, chunk)
                for key, val in (("fwd_ms", fwd_ms), ("fwd_bound_ms", fb),
                                 ("bwd_ms", bwd_ms), ("bwd_bound_ms", bb)):
                    rep[key][chunk] = val
                line += (f"; fwd kernel {fwd_ms:.4f} ms bound {fb:.4f} ({fb_by}, "
                         f"{fb / fwd_ms:.2%}); bwd kernel {bwd_ms:.4f} ms bound {bb:.4f} "
                         f"({bb_by}, {bb / bwd_ms:.2%})")
                if chunk == STATIC_CHUNK:
                    rep["fwd_plain_ms"] = cuda_time_ms(lambda: fwd(plain=True), reps=5)
                    rep["bwd_plain_ms"] = cuda_time_ms(lambda: bwd(out32, ref_lse, plain=True),
                                                       reps=5)
                    line += (f"; plain fwd {rep['fwd_plain_ms']:.4f} ms, bwd "
                             f"{rep['bwd_plain_ms']:.4f} ms")
            log(line + f" [{name}]")

    # K1 at the encoder decode shape (BH=64, T'=399), chunk STATIC_CHUNK
    for dtype in (torch.float32, torch.bfloat16):
        args = slice_shapes(torch.Generator().manual_seed(SEED + 7), dev, dtype)["encoder_rel"]
        scale = args["q"].shape[-1] ** -0.5
        out = fa.flash_attention(scale=scale, chunk=STATIC_CHUNK, **args)
        ref = fa.flash_attention_plain(scale=scale, chunk=STATIC_CHUNK, **args)
        torch.cuda.synchronize()
        err, tol = (out.float() - ref.float()).abs().max().item(), KERNEL_TOL[dtype]
        if not within(out, ref, tol):
            raise RuntimeError(f"K1 chunk {STATIC_CHUNK} {dtype}: max abs err {err} > {tol}")
        line = (f"K1 encoder_rel {str(dtype)[6:]} shape={tuple(args['q'].shape)} chunk "
                f"{STATIC_CHUNK}: max_abs_err={err:.3g} (tol {tol})")
        if dtype == torch.bfloat16:
            ms = cuda_time_ms(lambda: fa.flash_attention(scale=scale, chunk=STATIC_CHUNK, **args))
            full_ms = cuda_time_ms(lambda: fa.flash_attention(scale=scale, **args))
            plain_ms = cuda_time_ms(
                lambda: fa.flash_attention_plain(scale=scale, chunk=STATIC_CHUNK, **args))
            bnd, by = fwd_bound(chunk=STATIC_CHUNK, **args)
            rep.update(k1_err=err, k1_ms=ms, k1_full_ms=full_ms, k1_plain_ms=plain_ms,
                       k1_bound_ms=bnd, k1_bound_by=by)
            line += (f"; kernel {ms:.4f} ms (no chunk {full_ms:.4f}), plain {plain_ms:.4f} "
                     f"ms, bound {bnd:.4f} ms ({by}) = {bnd / ms:.2%} of it")
        log(line + f" [{name}]")
    return rep


def stream_overrides(root, run):
    return ["task=asr", "model=my_U2", "criterion=my_hybrid_ctc", "optimizer=my_noam",
            f"task.vocab={root}/vocab.txt", f"task.train={root}/train",
            f"task.valid={root}/valid", f"task.test=[{root}/valid]", "task.delimiter=' '",
            f"task.save_dir={run}/ckpts", f"common.run_dir={run}", f"common.seed={SEED}",
            "model.dtype=bfloat16", "model.dropout_rate=0.1", "model.enc_arch=transformer",
            f"dataset.batch_size={TRAIN_BATCH}", "dataset.max_len_in=1000",
            "postprocess.workflow=[]", f"optimization.accum_grad={ACCUM}",
            "optimization.clip_grad_norm=5.0"]


def train_stream(fa, root, run, extra, epochs, dev, name):
    """One streaming model trained through train.main; checks the launches
    (12 K1' and 12 K2 per micro-batch, the encoder and decoder K1 per valid
    batch), finite losses, moved parameters and the valid lines. Returns
    the trainer, its (K1, K1', K2) launches and those of them that ran with
    a chunk width."""
    from liteasr_tpu_torch import train

    reset_counts(fa)
    t0 = time.perf_counter()
    trainer = train.main(stream_overrides(root, run) + extra
                         + [f"optimization.max_epoch={epochs}"], device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fwd, lse, bwd = counts(fa)
    chunked = chunk_counts(fa)
    micro = epochs * len(trainer.task.dataset("train"))
    n_valid = epochs * len(trainer.valid_set)
    if (lse, bwd, fwd - lse) != (ENC_LAYERS * micro, ENC_LAYERS * micro,
                                 (ENC_LAYERS + 2 * DEC_LAYERS) * n_valid):
        raise RuntimeError(f"streaming launches K1' {lse}, K2 {bwd}, K1 {fwd - lse} for "
                           f"{micro} micro-batches and {n_valid} valid batches")
    losses = torch.stack(trainer._loss_accum).float().cpu()
    if len(losses) != micro or not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"streaming training losses {losses.tolist()}")
    init = dict(build_model(torch.bfloat16, "cpu", enc_arch="transformer").named_parameters())
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach().cpu(), init[n])]  # same seed as train.main
    if int(trainer.tx.count) < 1 or len(moved) < len(init) // 2:
        raise RuntimeError(f"{int(trainer.tx.count)} steps applied, {len(moved)} moved")
    valid_lines = valid_epochs(os.path.join(run, "train.log"))
    if valid_lines != list(range(1, epochs + 1)):
        raise RuntimeError(f"'valid loss:' lines for epochs {valid_lines}")
    log(f"streaming train {' '.join(extra)}: {micro} micro-batches of <= {TRAIN_BATCH} utts "
        f"in {epochs} epochs, {int(trainer.tx.count)} optimizer steps "
        f"({int(trainer.tx.notfinite_count)} skipped), {secs:.2f} s incl. validation and "
        f"checkpoints; losses {[round(v, 3) for v in losses.tolist()]}; K1' {lse}, K2 "
        f"{bwd}, K1 {fwd - lse} launches (with a chunk width: K1' {chunked[1]}, K2 "
        f"{chunked[2]}, K1 {chunked[0]}); {len(moved)} of {len(init)} leaves moved [{name}]")
    return trainer, (fwd - lse, lse, bwd), chunked


def infer_stream(fa, run, epoch, mode, chunk_sub, dev, name):
    """infer.infer of a streaming checkpoint in a streaming mode: no K1
    launch (the chunk attention over the cache is plain, as the JAX
    package's is XLA), every utterance scored."""
    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    cfg = compose([f"inference.ckpt_name={epoch}", "inference.model_avg=false",
                   f"inference.batch_size={N_VALID}", f"inference.beam_size={BEAM}",
                   f"inference.mode={mode}", f"inference.chunk_sub={chunk_sub}"],
                  base=load_yaml(os.path.join(run, "config.yaml")))
    reset_counts(fa)
    t0 = time.perf_counter()
    results = infer.infer(cfg, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if counts(fa) != (0, 0, 0) or results[0][1] <= 0:
        raise RuntimeError(f"streaming infer {mode}: {results}, launches {counts(fa)}")
    log(f"infer {mode} chunk_sub {chunk_sub} of {os.path.basename(run)}/model.ep.{epoch}.pt "
        f"on the {N_VALID} valid utterances in {secs:.2f} s incl. loading: error count "
        f"{results[0][0]}/{results[0][1]} (random data) [{name}]")


def run_stream_training(fa, root, dev, name):
    """Phase l. Returns the (K1, K1', K2) launches of the dynamic-chunk and
    of the static-chunk training run, then those of each that ran with a
    chunk width."""
    import logging

    run = os.path.join(root, "stream_run")
    trainer, dyn, dyn_c = train_stream(fa, root, run, ["model.dynamic_chunk=true",
                                                "common.log_level=DEBUG"], TRAIN_EPOCHS, dev,
                                name)
    logging.getLogger().setLevel(logging.INFO)
    micro = TRAIN_EPOCHS * len(trainer.task.dataset("train"))
    with open(os.path.join(run, "train.log")) as f:
        widths = [ln.rsplit("dynamic chunk width: ", 1)[1].strip()
                  for ln in f if "dynamic chunk width: " in ln]
    chunked = [int(w) for w in widths if w != "full context"]
    if (len(widths) != micro or not chunked or len(chunked) == len(widths)
            or not all(1 <= w <= 25 for w in chunked)):
        raise RuntimeError(f"drawn chunk widths {widths} for {micro} micro-batches")
    log(f"dynamic chunk widths drawn, one per micro-batch: {widths} [{name}]")
    # the chunked draws' micro-batches, and only they, ran K1'/K2 chunked;
    # validation is full context
    if dyn_c != (0, ENC_LAYERS * len(chunked), ENC_LAYERS * len(chunked)):
        raise RuntimeError(f"dynamic run: chunked (K1, K1', K2) launches {dyn_c} for "
                           f"{len(chunked)} chunked draws")
    del trainer
    static_run = os.path.join(root, "static_run")
    trainer, sta, sta_c = train_stream(fa, root, static_run,
                                       [f"model.static_chunk_size={STATIC_CHUNK}"], 1, dev,
                                       name)
    if trainer.model.encoder.static_chunk_size != STATIC_CHUNK:
        raise RuntimeError("the static run has no chunk width")
    micro, n_valid = len(trainer.task.dataset("train")), len(trainer.valid_set)
    if sta_c != (ENC_LAYERS * n_valid, ENC_LAYERS * micro, ENC_LAYERS * micro):
        raise RuntimeError(f"static run: chunked (K1, K1', K2) launches {sta_c} for "
                           f"{micro} micro-batches and {n_valid} valid batches")
    del trainer
    for mode in ("streaming_ctc_greedy", "streaming_ctc_prefix_beam_search"):
        infer_stream(fa, run, TRAIN_EPOCHS, mode, STREAM_CHUNK_SUB, dev, name)
    infer_stream(fa, static_run, 1, "streaming_ctc_greedy", STREAM_CHUNK_SUB, dev, name)
    return dyn, sta, dyn_c, sta_c


def time_stream_step(dev, name):
    """Phase l: the streaming model's micro-step at bench.py's point with
    chunk STATIC_CHUNK and with full context: median of 3 x 5, peak memory."""
    for chunk in (STATIC_CHUNK, 0):
        gc.collect()
        torch.cuda.empty_cache()
        step, B = bench_step(dev, enc_arch="transformer", static_chunk_size=chunk)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) / 5)
        if not bool(torch.isfinite(loss)):
            raise RuntimeError("non-finite loss in the streaming step timing")
        med = statistics.median(reps)
        log(f"streaming train step bf16 at bench.py's point (B={B}, T=800, U=48), "
            f"{'chunk ' + str(chunk) if chunk else 'full context'}: median {med * 1e3:.2f} "
            f"ms/micro-step (of 3 x 5), {B / med:.2f} utt/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{name}]")
        del step


def run_stream_decode(fa, task, dev, name):
    """Phase m. Returns the K1 launches of the offline decode and those of
    them with the chunk width, the decoded (ref, hyp) pairs and the s/batch
    by configuration."""
    from types import SimpleNamespace

    from liteasr_tpu_torch import infer, streaming
    from liteasr_tpu_torch.infer import infer_dataset

    dataset = task.dataset("test")
    model = build_model(torch.bfloat16, dev, enc_arch="transformer", dynamic_chunk=True)
    n_batches = -(-len(dataset.data) // BATCH)
    audio_s = sum(a.xlen for a in dataset.data) * FRAME_S
    warm = SimpleNamespace(data=dataset.data[:BATCH], feat_dim=dataset.feat_dim)
    all_pairs, per_batch = [], {}
    for mode, chunk_sub in (("streaming_ctc_greedy", 16), ("streaming_ctc_greedy", 8),
                            ("streaming_ctc_prefix_beam_search", 16)):
        cfg = {"batch_size": BATCH, "beam_size": BEAM, "mode": mode, "chunk_sub": chunk_sub}
        infer_dataset(task, model, warm, cfg, dev, PAD_TIME, verbose=False)
        torch.cuda.synchronize()
        reset_counts(fa)
        decode_s = []

        def timed(*args, **kwargs):  # the decode alone, without the scoring
            t1 = time.perf_counter()
            out = streaming.streaming_decode(*args, **kwargs)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t1)
            return out

        infer.streaming_decode = timed
        try:
            t0 = time.perf_counter()
            pairs = []
            err, length = infer_dataset(task, model, dataset, cfg, dev, PAD_TIME,
                                        verbose=False, collect=pairs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            infer.streaming_decode = streaming.streaming_decode
        if counts(fa) != (0, 0, 0) or len(pairs) != len(dataset.data) or length <= 0:
            raise RuntimeError(f"streaming decode {mode}: launches {counts(fa)}, "
                               f"{len(pairs)} pairs")
        dec = sum(decode_s)
        n_tok = sum(len(hyp.split()) for _, hyp in pairs)
        log(f"streaming decode {mode} chunk_sub {chunk_sub} ({chunk_sub * 40} ms chunks): "
            f"{n_batches} batches of <= {BATCH} utts, {secs / n_batches:.4f} s/batch through "
            f"infer_dataset, of which the decode {dec / n_batches:.4f} s/batch; "
            f"{len(pairs) / secs:.2f} utt/s, RTF {secs / audio_s:.5f} (decode alone "
            f"{len(pairs) / dec:.2f} utt/s, RTF {dec / audio_s:.5f}); {n_tok} tokens, error "
            f"count {err}/{length} (random weights) [{name}]")
        all_pairs += pairs
        per_batch[f"{mode}/{chunk_sub}"] = secs / n_batches
    del model

    # the streaming step as tools/bench_streaming.py times it
    static = build_model(torch.bfloat16, dev, enc_arch="transformer",
                         static_chunk_size=STATIC_CHUNK)
    C = 4 * STREAM_CHUNK_SUB
    T = STREAM_N_CHUNKS * C + 4
    L = STREAM_N_CHUNKS * STREAM_CHUNK_SUB
    xs = torch.from_numpy(np.random.default_rng(SEED).normal(size=(STREAM_B, T, FEAT))
                          .astype(np.float32)).to(dev)
    xlens = torch.full((STREAM_B,), T, dtype=torch.int64, device=dev)
    sub_xlens = torch.clamp(((xlens - 1) // 2 - 1) // 2, max=L)
    key_lens = torch.clamp((xlens + 3) // 4, max=L)
    lat = []
    with torch.inference_mode():
        state = streaming.init_stream_state(static, STREAM_B, STREAM_CHUNK_SUB,
                                            STREAM_N_CHUNKS, device=dev)
        for t in range(STREAM_N_CHUNKS):
            t0 = time.perf_counter()
            h = streaming.stream_step(static, state, xs[:, t * C: t * C + C + 4], sub_xlens,
                                      key_lens, L)
            torch.cuda.synchronize()
            if t:  # chunk 0 warms up
                lat.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(h).all()) or state["index"] != L:
        raise RuntimeError("the streaming step gave non-finite states")
    med, p95 = statistics.median(lat), float(np.percentile(lat, 95))
    chunk_s = STREAM_CHUNK_SUB * 4 * FRAME_S
    log(f"streaming step (B={STREAM_B}, chunk_sub {STREAM_CHUNK_SUB} = {chunk_s * 1e3:.0f} ms "
        f"of audio, {STREAM_N_CHUNKS} chunks, static_chunk_size {STATIC_CHUNK}, bf16, a sync "
        f"per chunk): median {med:.2f} ms/chunk, p95 {p95:.2f} ms, streaming RTF "
        f"{med / 1e3 / chunk_s:.4f} [{name}]")
    # the same stream again, traced with device activity only: device busy
    # time and ops a chunk against the traced wall
    from torch.profiler import ProfilerActivity

    with torch.inference_mode():
        state = streaming.init_stream_state(static, STREAM_B, STREAM_CHUNK_SUB,
                                            STREAM_N_CHUNKS, device=dev)

        def chunk_step():
            t = state["index"] // STREAM_CHUNK_SUB
            streaming.stream_step(static, state, xs[:, t * C: t * C + C + 4], sub_xlens,
                                  key_lens, L)

        _, wall_us, busy, ops = traced_steps(chunk_step, STREAM_N_CHUNKS,
                                             [ProfilerActivity.CUDA])
    n = STREAM_N_CHUNKS
    log(f"streaming step traced (device activity only, {n} chunks): device busy "
        f"{busy / 1e3 / n:.2f} ms/chunk of {wall_us / 1e3 / n:.2f} ms traced wall = "
        f"{busy / wall_us:.1%}; {ops / n:.0f} device ops/chunk [{name}]")
    k1, off_s = run_slice(fa, task, dev, name, mode="ctc_greedy", model=static)
    k1_chunked = chunk_counts(fa)[0]  # counted in run_slice's timed pass
    per_batch["ctc_greedy offline, chunk 16"] = off_s
    return k1, k1_chunked, all_pairs, per_batch


def check_stream_parity(task, dev, name, pairs):
    """Phase n, fp32 (TF32 off)."""
    from liteasr_tpu_torch import decode, native, streaming
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss
    from liteasr_tpu_torch.nets.subsampling import subsampled_length
    from liteasr_tpu_torch.trainer import to_device
    from liteasr_tpu_torch.utils import score

    # the first 600 and 480 frames of two test utterances, padded to the
    # stream's capacity (10 chunks of 64 frames + 4) for the offline encoder
    cut = (600, 480)
    n_chunks = -(-(cut[0] - 4) // (4 * STREAM_CHUNK_SUB))
    T = n_chunks * 4 * STREAM_CHUNK_SUB + 4
    xs = np.zeros((2, T, FEAT), np.float32)
    for i, (a, n) in enumerate(zip(task.dataset("test").data, cut)):
        xs[i, :n] = a.x[:n]
    xs, xlens = torch.from_numpy(xs), torch.tensor(cut)
    got = []  # [card, CPU]
    for device in (dev, torch.device("cpu")):
        model = build_model(torch.float32, device, enc_arch="transformer",
                            static_chunk_size=STATIC_CHUNK)
        x, xl = xs.to(device), xlens.to(device)
        t0 = time.perf_counter()
        greedy, h_str = streaming.streaming_decode(model, x, xl, STREAM_CHUNK_SUB,
                                                   n_chunks=n_chunks, collect_enc=True)
        beam = streaming.streaming_decode(model, x, xl, STREAM_CHUNK_SUB,
                                          "ctc_prefix_beam_search", BEAM, n_chunks=n_chunks)
        got.append((greedy, beam, time.perf_counter() - t0))
        if len(got) == 1:  # the card
            with torch.inference_mode():
                h_off, _ = model.encode(x, xl)
            off = decode.decode_batch(model, x, xl, mode="ctc_greedy")
            errs = []
            for b, n in enumerate(cut):
                ls = subsampled_length(n)
                a, r = h_str[b, :ls].cpu(), h_off[b, :ls].cpu()
                errs.append((a - r).abs().max().item())
                if not torch.allclose(a, r, **STREAM_TOL):
                    raise RuntimeError(f"streaming vs offline chunked encoder on the card: "
                                       f"max abs diff {errs[-1]} beyond {STREAM_TOL}")
            if greedy != off:
                raise RuntimeError("streaming and offline greedy hypotheses differ on the card")
            log(f"stream parity fp32 on the card (2 utts of {list(cut)} frames, {n_chunks} "
                f"chunks of {STREAM_CHUNK_SUB}): hidden states vs the offline chunked "
                f"encoder max abs diff {max(errs):.3g} (rtol/atol {STREAM_TOL}), greedy "
                f"hypotheses identical to the offline ones (lens "
                f"{[len(h) for h in greedy]}) [{name}]")
        del model
    (g_greedy, g_beam, g_s), (c_greedy, c_beam, c_s) = got
    if g_greedy != c_greedy or g_beam != c_beam:
        raise RuntimeError("streaming hypotheses differ between the card and the CPU")
    log(f"stream parity card vs CPU fp32: greedy and prefix beam {BEAM} hypotheses "
        f"identical (lens {[len(h) for h in g_greedy]}, {[len(h) for h in g_beam]}); "
        f"{g_s:.2f} s card, {c_s:.2f} s CPU [{name}]")

    # one dynamic-chunk train step at chunk 8, the card against the CPU in fp64
    rng = np.random.default_rng(SEED + 8)
    B, T, U = 4, 400, 24
    batch = {"xs": rng.normal(size=(B, T, FEAT)).astype(np.float32),
             "xlens": np.array([T, 350, 280, 200], np.int32),
             "ys": rng.integers(1, VOCAB - 1, size=(B, U)).astype(np.int32),
             "ylens": np.array([U, 20, 16, 10], np.int32),
             "valid": np.ones(B, np.float32)}
    crit = HybridCTCLoss(DotDict(vocab_size=VOCAB, padding_idx=-1, smoothing=0.1,
                                 ctc_weight=0.3))
    res = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        model = build_model(dtype, device, enc_layers=2, dec_layers=1,
                            enc_arch="transformer", dynamic_chunk=True).to(dtype)
        model.encoder.draw_chunk = lambda: 8
        b = to_device(batch, device)
        b["xs"] = b["xs"].to(dtype)
        loss, _ = crit(model, b, train=True)
        loss.backward()
        res.append((loss.item(), {n: p.grad.double().cpu()
                                  for n, p in model.named_parameters()}))
    what = grad_agreement(res[0][0], res[0][1], res[1][0], res[1][1])
    log(f"dynamic-chunk train parity at chunk 8, fp32 card vs CPU fp64 (2 + 1 layers, "
        f"B={B}, T={T}): {what} [{name}]")

    # the native host library, on m's decoded pairs
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not load")
    t0 = time.perf_counter()
    fast = native.levenshtein_batch(pairs)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = [score._levenshtein_py(r, h) for r, h in pairs]
    t_py = time.perf_counter() - t0
    if fast != slow or [score.levenshtein(r, h) for r, h in pairs] != slow:
        raise RuntimeError("the native Levenshtein differs from the pure-Python one")
    log(f"native library {native.library_path().name} loaded; Levenshtein of {len(pairs)} "
        f"decoded pairs equal to the pure-Python one, {t_native * 1e3:.2f} ms (one batched "
        f"call) against {t_py * 1e3:.2f} ms [{name}]")


# ---------------------------------------------------------- Paraformer (o-s)


def para_kernel_shapes(gen, dev, dtype):
    """K1's four new calls in the parallel decoder (no rel-pos term): pass 1
    of a training step at bench.py's point (B=32 x 4 heads, U=48 queries):
    self-attention with no mask and source attention over T'=199 with
    kv_lens; and a decoded batch (B=16 x 4 heads, u_max = T' = 399): the
    same two, 399 x 399."""
    d = DIM // HEADS

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def lens(b, t):
        kv = torch.randint(t // 2, t + 1, (b,), generator=gen)
        kv[0] = t
        return kv.repeat_interleave(HEADS).to(dev, torch.int32)

    tb, db, u, t_tr, t_dec = 32 * HEADS, BATCH * HEADS, 48, TRAIN_T, 399
    return {
        "pass1_self": dict(q=rnd(tb, u, d), k=rnd(tb, u, d), v=rnd(tb, u, d)),
        "pass1_src_kv_lens": dict(q=rnd(tb, u, d), k=rnd(tb, t_tr, d), v=rnd(tb, t_tr, d),
                                  kv_lens=lens(32, t_tr)),
        "decode_self": dict(q=rnd(db, t_dec, d), k=rnd(db, t_dec, d), v=rnd(db, t_dec, d)),
        "decode_src_kv_lens": dict(q=rnd(db, t_dec, d), k=rnd(db, t_dec, d),
                                   v=rnd(db, t_dec, d), kv_lens=lens(BATCH, t_dec)),
    }


def check_k1_calls(fa, dev, name, label, shapes, seed):
    """K1 at a family's call shapes (``shapes(gen, dev, dtype)`` -> {shape:
    args}) against the plain version, fp32 (TF32 off) and bf16, each bf16
    call timed beside its bound and one SDPA call with the same mask.
    Returns the bf16 figures by shape and the largest bf16 error."""
    gen = torch.Generator().manual_seed(seed)
    report = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, args in shapes(gen, dev, dtype).items():
            scale = args["q"].shape[-1] ** -0.5
            out = fa.flash_attention(scale=scale, **args)
            ref = fa.flash_attention_plain(scale=scale, **args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = KERNEL_TOL[dtype]
            if not within(out, ref, tol):
                raise RuntimeError(f"K1 {label} {shape} {dtype}: max abs err {err} "
                                   f"exceeds atol=rtol={tol}")
            ms = cuda_time_ms(lambda: fa.flash_attention(scale=scale, **args))
            plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(scale=scale, **args))
            lib_ms = cuda_time_ms(library_call(args, scale))
            bound_ms, bound_by = fwd_bound(**args)
            log(f"K1 {label} {shape} {str(dtype)[6:]} shape={tuple(args['q'].shape)}x"
                f"{args['k'].shape[1]}: max_abs_err={err:.3g} (tol {tol}) kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA) {lib_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}) = {bound_ms / ms:.2%} of it [{name}]")
            if dtype == torch.bfloat16:
                report["max_abs_err"] = max(report["max_abs_err"], err)
                report[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound_ms, bound_by=bound_by)
    return report


def check_para_kernels(fa, dev, name):
    """Phase o: K1 at the Paraformer decoder's four shapes."""
    return check_k1_calls(fa, dev, name, "Paraformer", para_kernel_shapes, SEED + 7)


def build_para_model(dtype, device, enc_layers=ENC_LAYERS, dec_layers=DEC_LAYERS,
                     dropout_rate=0.0):
    """ParaformerConfig's defaults at full width (12 conformer layers, DIM,
    HEADS, FF 2048, swish; the CIF predictor; 6 parallel decoder layers;
    sample_ratio 0.75, glance_at_eval), random weights from SEED."""
    from liteasr_tpu_torch.models.paraformer import Paraformer

    gen = torch.Generator().manual_seed(SEED)
    rates = {k: dropout_rate for k in (
        "enc_dropout_rate", "enc_pos_dropout_rate", "enc_attn_dropout_rate",
        "enc_ff_dropout_rate", "dec_dropout_rate", "dec_self_attn_dropout_rate",
        "dec_src_attn_dropout_rate", "dec_ff_dropout_rate", "pos_dropout_rate")}
    return Paraformer(input_dim=FEAT, vocab_size=VOCAB, enc_dim=DIM, enc_ff_dim=2048,
                      enc_attn_heads=HEADS, enc_layers=enc_layers, dec_dim=DIM,
                      dec_ff_dim=2048, dec_attn_heads=HEADS, dec_layers=dec_layers,
                      dtype=dtype, device=device, generator=gen, **rates)


def run_para_training(fa, root, dev, name):
    """Phase p: the Paraformer through train.main at full width on the
    corpus of 6, then infer.infer of its checkpoint. Returns the (K1, K1',
    K2) launches of the training run and the K1 launches of the decode."""
    from liteasr_tpu_torch import infer, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml
    from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss

    run = os.path.join(root, "para_run")
    overrides = train_overrides("paraformer", root, run, TRAIN_EPOCHS)
    parts = []  # (train, loss_ce, loss_mae) of every criterion call
    call = ParaformerLoss.__call__

    def record(self, model, batch, train=True):
        loss, aux = call(self, model, batch, train)
        parts.append((train, aux["loss_ce"].item(), aux["loss_mae"].item()))
        return loss, aux

    ParaformerLoss.__call__ = record
    try:
        reset_counts(fa)
        t0 = time.perf_counter()
        trainer = train.main(overrides, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        ParaformerLoss.__call__ = call
    fwd, lse, bwd = counts(fa)
    micro = TRAIN_EPOCHS * len(trainer.task.dataset("train"))
    n_valid = TRAIN_EPOCHS * len(trainer.valid_set)
    # per micro-batch: the encoder's K1'/K2 and pass 1's K1 (self + source
    # per decoder layer; pass 2 trains, in plain attention); per valid batch
    # the encoder's and both passes' K1
    want = (ENC_LAYERS * micro, ENC_LAYERS * micro,
            2 * DEC_LAYERS * micro + (ENC_LAYERS + 4 * DEC_LAYERS) * n_valid)
    if (lse, bwd, fwd - lse) != want:
        raise RuntimeError(f"Paraformer launches K1' {lse}, K2 {bwd}, K1 {fwd - lse} for "
                           f"{micro} micro-batches and {n_valid} valid batches, "
                           f"expected {want}")
    losses = torch.stack(trainer._loss_accum).float().cpu()
    train_parts = [p[1:] for p in parts if p[0]]
    if (len(losses) != micro or not bool(torch.isfinite(losses).all())
            or len(train_parts) != micro or not np.isfinite(train_parts).all()):
        raise RuntimeError(f"Paraformer training losses {losses.tolist()}, "
                           f"(loss_ce, loss_mae) {train_parts}")
    init = dict(build_para_model(torch.bfloat16, "cpu").named_parameters())
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach().cpu(), init[n])]  # same seed as train.main
    pred = [n for n in init if n.startswith("predictor.")]
    if (int(trainer.tx.count) < 1 or len(moved) < len(init) // 2
            or not set(pred) <= set(moved)):
        raise RuntimeError(f"{int(trainer.tx.count)} steps applied, {len(moved)} "
                           f"parameters moved, predictor leaves not moved: "
                           f"{sorted(set(pred) - set(moved))}")
    with open(os.path.join(run, "train.log")) as f:
        valid_lines = [ln for ln in f if "valid loss:" in ln]
    if len(valid_lines) != TRAIN_EPOCHS:
        raise RuntimeError(f"{len(valid_lines)} 'valid loss:' lines")
    ckpt = os.path.join(run, "ckpts", f"model.ep.{TRAIN_EPOCHS}.pt")
    if not os.path.isfile(ckpt):
        raise RuntimeError(f"{ckpt} was not written")
    log(f"Paraformer train: {micro} micro-batches of <= {TRAIN_BATCH} utts in "
        f"{TRAIN_EPOCHS} epochs, {int(trainer.tx.count)} optimizer steps "
        f"({int(trainer.tx.notfinite_count)} skipped), {secs:.2f} s incl. validation and "
        f"checkpoints; losses {[round(x, 3) for x in losses.tolist()]}; (loss_ce, "
        f"loss_mae) {[(round(a, 3), round(b, 3)) for a, b in train_parts]}; K1' {lse}, "
        f"K2 {bwd}, K1 {fwd - lse} launches; {len(moved)} of {len(init)} parameter "
        f"leaves moved, the {len(pred)} predictor leaves among them; "
        f"{valid_lines[-1].split(' - ')[-1].strip()} [{name}]")
    del trainer

    cfg = compose([f"inference.ckpt_name={TRAIN_EPOCHS}", "inference.model_avg=false",
                   f"inference.batch_size={N_VALID}"],
                  base=load_yaml(os.path.join(run, "config.yaml")))
    reset_counts(fa)
    results = infer.infer(cfg, device=dev)
    torch.cuda.synchronize()
    dec_fwd = counts(fa)[0]
    if dec_fwd != ENC_LAYERS + 2 * DEC_LAYERS or results[0][1] <= 0:
        raise RuntimeError(f"decoding the Paraformer checkpoint: {results}, K1 {dec_fwd}")
    log(f"Paraformer infer of model.ep.{TRAIN_EPOCHS}.pt on the {N_VALID} valid "
        f"utterances: error count {results[0][0]}/{results[0][1]} (2 epochs on random "
        f"data), K1 launches {dec_fwd} [{name}]")
    return (fwd - lse, lse, bwd), dec_fwd


def para_bench_step(dev, shard=False):
    """The full-width bf16 Paraformer micro-step (dropout 0.1, glancing,
    Noam Adam, clip 5, accum 2) on bench_batch; returns (step, B).
    ``shard``: on this rank's tp/sp shard of the model (z10)."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam
    from liteasr_tpu_torch.optims.noam import noam_schedule
    from liteasr_tpu_torch.parallel import sharding

    torch.manual_seed(SEED)
    model = build_para_model(torch.bfloat16, dev, dropout_rate=0.1)
    model.seed_dropout(SEED)
    if shard:
        sharding.shard_model(model, parallel.layout())
    crit = ParaformerLoss(DotDict(vocab_size=VOCAB, gamma=1.0))
    params = list(model.parameters())
    tx = FusedAdam(params, noam_schedule(256, 1.0, 25000), 0.9, 0.98, 1e-9,
                   clip=5.0, accum=ACCUM, sharded=sharding.sharded_parameters(model))
    batch, B = bench_batch(dev)

    def step():
        loss, _ = crit(model, batch, train=True)
        loss.backward()
        tx.update([p.grad for p in params])
        for p in params:
            p.grad = None
        return loss

    return step, B


def time_para_step(dev, name):
    """Phase q: the Paraformer micro-step at bench.py's point (bf16, dropout
    0.1, Noam Adam, clip 5, accum 2): median of 5 repetitions of 4
    micro-steps, utt/s and peak memory; then cif_dense and cif_scan each
    alone, forward and backward, at its CIF shape (B=32, T'=199, U=48) and
    at the decode shape (B=16, U=T'=399). Returns {what: ms}."""
    from liteasr_tpu_torch.nets.paraformer import DENSE_CIF_MAX_CELLS, cif_dense, cif_scan

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, B = para_bench_step(dev)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            loss = step()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 4)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite Paraformer loss in the timed steps")
    med = statistics.median(reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"step_ms": med * 1e3, "utt_s": B / med, "peak_gib": peak}
    del step
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(SEED + 8)
    parts = []
    for label, b, t, u in (("train", 32, TRAIN_T, 48), ("decode", BATCH, 399, 399)):
        alpha = (0.05 + 0.9 * torch.rand(b, t, generator=gen)).to(dev).requires_grad_()
        xs = torch.randn(b, t, DIM, generator=gen).to(dev).requires_grad_()
        with torch.no_grad():
            beta = alpha.sum(1) / u - 1e-4
        beta.requires_grad_()
        gout = torch.randn(b, u, DIM, generator=gen).to(dev)
        for fn in (cif_dense, cif_scan):
            def fwd_bwd(fn=fn):
                fn(alpha, xs, beta, u).backward(gout)
                alpha.grad = xs.grad = beta.grad = None

            ms = host_time_ms(fwd_bwd)
            fwd_ms = host_time_ms(lambda fn=fn: fn(alpha, xs, beta, u))
            out[f"{fn.__name__}_{label}_ms"] = ms
            out[f"{fn.__name__}_{label}_fwd_ms"] = fwd_ms
            parts.append(f"{fn.__name__} {label} (B={b}, T'={t}, U={u}) fwd {fwd_ms:.2f} ms, "
                         f"fwd+bwd {ms:.2f} ms")
        pick = "cif_dense" if u * t <= DENSE_CIF_MAX_CELLS else "cif_scan"
        parts.append(f"the size rule picks {pick} at {label}")
    log(f"Paraformer train step at bench.py's point (B={B}, T=800, U=48, V={VOCAB}, bf16, "
        f"accum {ACCUM}): median {med * 1e3:.2f} ms/micro-step (best {min(reps) * 1e3:.2f}; "
        f"5 x 4 steps), {B / med:.2f} utt/s, peak memory {peak:.2f} GiB; alone: "
        + "; ".join(parts) + f" [{name}]")
    return out


def run_para_decode(fa, task, dev, name):
    """Phase r: the test corpus decoded with the full-width Paraformer
    (random bf16 weights from SEED) through infer_dataset: a warm-up batch,
    then the timed pass with the counts reset. Returns the K1 launches and
    s/batch."""
    from types import SimpleNamespace

    from liteasr_tpu_torch import decode
    from liteasr_tpu_torch.infer import infer_dataset

    dataset = task.dataset("test")
    model = build_para_model(torch.bfloat16, dev).eval()
    n_batches = -(-len(dataset.data) // BATCH)
    audio_s = sum(a.xlen for a in dataset.data) * FRAME_S
    cfg = {"batch_size": BATCH}
    warm = SimpleNamespace(data=dataset.data[:BATCH], feat_dim=dataset.feat_dim)
    infer_dataset(task, model, warm, cfg, dev, PAD_TIME, verbose=False)
    torch.cuda.synchronize()
    reset_counts(fa)
    decode_fn = decode.paraformer_decode
    decode_s = []

    def timed(*args, **kwargs):  # the decode alone, without the scoring
        t1 = time.perf_counter()
        out = decode_fn(*args, **kwargs)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t1)
        return out

    decode.paraformer_decode = timed
    try:
        t0 = time.perf_counter()
        pairs = []
        err, length = infer_dataset(task, model, dataset, cfg, dev, PAD_TIME,
                                    verbose=False, collect=pairs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        decode.paraformer_decode = decode_fn
    launches = fa.flash_attention.launches
    per_batch = ENC_LAYERS + 2 * DEC_LAYERS
    if launches != per_batch * n_batches:
        raise RuntimeError(f"K1 launched {launches} times for {n_batches} batches, "
                           f"expected {per_batch} per batch")
    if len(pairs) != len(dataset.data) or length <= 0:
        raise RuntimeError("infer_dataset did not score every utterance")
    n_tok = sum(len(hyp.split()) for _, hyp in pairs)
    dec = sum(decode_s)
    log(f"Paraformer decode (CIF + argmax): {n_batches} batches of <= {BATCH} utts "
        f"(longest padded to 1600 frames, u_max 399), {secs / n_batches:.4f} s/batch "
        f"through infer_dataset, of which the decode {dec / n_batches:.4f} s/batch and "
        f"the host's scoring the rest; {len(pairs) / secs:.2f} utt/s, RTF "
        f"{secs / audio_s:.5f} (decode alone {len(pairs) / dec:.2f} utt/s, RTF "
        f"{dec / audio_s:.5f}); K1 launches {launches} ({per_batch}/batch), {n_tok} "
        f"tokens emitted, error count {err}/{length} (random weights) [{name}]")
    return launches, secs / n_batches


def fire_mismatch(k_a, k_b, csum, beta) -> str:
    """The frames where two fire-count tensors (B, T) differ, with csum /
    beta there (a flip sits at an integer)."""
    rows, cols = torch.nonzero(k_a != k_b, as_tuple=True)
    ratio = csum / beta[:, None]
    return ", ".join(f"utt {int(r)} frame {int(c)}: {int(k_a[r, c])} vs {int(k_b[r, c])} "
                     f"fires, csum/beta {float(ratio[r, c]):.9f}"
                     for r, c in zip(rows[:8], cols[:8]))


def check_para_parity(task, dev, name):
    """Phase s, fp32 (TF32 off), the glance noise handed to both sides: one
    train step (full width, 2 encoder and 1 decoder layer, dropout 0) on
    the card held to the train-parity rule against the same step on the CPU
    in fp64, the fire counts of its CIF first; then 2 cut utterances
    decoded by the full-width model (decoder projection x8 for peaked
    posteriors) on the card and the CPU: identical fire counts, hypotheses
    and ulens."""
    from liteasr_tpu_torch import decode
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss
    from liteasr_tpu_torch.nets.paraformer import fire_counts
    from liteasr_tpu_torch.ops.masks import padding_mask
    from liteasr_tpu_torch.trainer import to_device

    rng = np.random.default_rng(SEED + 9)
    B, T, U = 4, 400, 24
    batch = {"xs": rng.normal(size=(B, T, FEAT)).astype(np.float32),
             "xlens": np.array([T, 350, 280, 200], np.int32),
             "ys": rng.integers(1, VOCAB - 1, size=(B, U)).astype(np.int32),
             "ylens": np.array([U, 20, 16, 10], np.int32),
             "valid": np.ones(B, np.float32)}
    batch["ys"][np.arange(U)[None] >= batch["ylens"][:, None]] = -1
    noise = torch.rand(B, U, generator=torch.Generator().manual_seed(SEED + 10))
    crit = ParaformerLoss(DotDict(vocab_size=VOCAB, gamma=1.0))
    res, fires = [], []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        model = build_para_model(dtype, device, enc_layers=2, dec_layers=1).to(dtype)
        model.draw_glance_noise = lambda b, u, train, d: noise.to(d)
        b = to_device(batch, device)
        b["xs"] = b["xs"].to(dtype)
        loss, aux = crit(model, b, train=True)
        loss.backward()
        res.append((loss.item(), {n: p.grad.double().cpu()
                                  for n, p in model.named_parameters()}))
        with torch.no_grad():  # the step's CIF (train mode, dropout 0)
            h = model.encoder(b["xs"], mask=padding_mask(b["xlens"], T), train=True)
            alpha, beta = model.predictor.alphas(h, model.get_pred_len(b["xlens"]),
                                                 b["ylens"])
            csum = torch.cumsum(alpha, 1)
            fires.append((fire_counts(csum, beta).cpu(), csum.double().cpu(),
                          beta.double().cpu()))
    (g_k, _, _), (c_k, c_csum, c_beta) = fires
    if not torch.equal(g_k, c_k):
        raise RuntimeError("Paraformer train step: the card's CIF fires differ from the "
                           "CPU's: " + fire_mismatch(g_k, c_k, c_csum, c_beta))
    what = grad_agreement(res[0][0], res[0][1], res[1][0], res[1][1])
    log(f"Paraformer train parity fp32 card vs CPU fp64 (2 encoder + 1 decoder layers, "
        f"B={B}, T={T}, U={U}, glance noise handed over): fire counts identical "
        f"({g_k[:, -1].tolist()} fires); {what} [{name}]")

    cut = (600, 480)
    xs = np.zeros((2, cut[0], FEAT), np.float32)
    for i, (a, n) in enumerate(zip(task.dataset("test").data, cut)):
        xs[i, :n] = a.x[:n]
    xs, xlens = torch.from_numpy(xs), torch.tensor(cut)
    outs = []
    for device in (dev, torch.device("cpu")):
        model = build_para_model(torch.float32, device).eval()
        with torch.no_grad():
            model.decoder.linear_out.weight.mul_(8.0)
            model.decoder.linear_out.bias.mul_(8.0)
        t0 = time.perf_counter()
        with torch.no_grad():
            x, xl = xs.to(device), xlens.to(device)
            h = model.encoder(x, mask=padding_mask(xl, x.shape[1]))
            alpha, beta = model.predictor.alphas(h, model.get_pred_len(xl))
            csum = torch.cumsum(alpha, 1)
            k = fire_counts(csum, beta)
            u_max = max(model.get_pred_len(x.shape[1]), 1)
            hyp, ulens = model.decode(x, xl, u_max)
        outs.append([t.cpu() for t in (k, csum, beta, hyp, ulens)]
                    + [decode.paraformer_decode(model, x, xl), time.perf_counter() - t0])
    (g_k, _, _, g_hyp, g_ul, g_lists, g_s), (c_k, c_csum, c_beta, c_hyp, c_ul, c_lists,
                                             c_s) = outs
    if not torch.equal(g_k, c_k):
        raise RuntimeError("Paraformer decode: the card's CIF fires differ from the "
                           "CPU's: " + fire_mismatch(g_k, c_k, c_csum.double(),
                                                     c_beta.double()))
    same = torch.equal(g_hyp, c_hyp) and torch.equal(g_ul, c_ul) and g_lists == c_lists
    log(f"Paraformer decode parity fp32 card vs CPU (2 utts of {list(cut)} frames, "
        f"linear_out x8): fire counts identical ({g_k[:, -1].tolist()} fires), "
        f"hypotheses {'identical' if same else 'DIFFER'} (ulens {g_ul.tolist()} vs "
        f"{c_ul.tolist()}); {g_s:.2f} s card, {c_s:.2f} s CPU [{name}]")
    if not same:
        raise RuntimeError("Paraformer decoding differs between the card and the CPU")


# ---------------------------------------------------------- wav2vec 2.0 (t-w)


def w2v_kernel_shapes(gen, dev, dtype):
    """K1's validation calls in the w2v2 encoder (12 heads of 64, no mask):
    the operating point's batch (24 rows x 174 frames) and the
    250,000-sample crop's (5 rows + 3 dummy rows x 774 frames)."""
    d = W2V_DIM // W2V_HEADS

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    return {shape: dict(q=rnd(bh, t, d), k=rnd(bh, t, d), v=rnd(bh, t, d))
            for shape, (bh, t) in W2V_SHAPES.items()}


def check_w2v_kernels(fa, dev, name):
    """Phase t: K1 at the two w2v2 validation shapes."""
    return check_k1_calls(fa, dev, name, "wav2vec2", w2v_kernel_shapes, SEED + 11)


def build_w2v_model(dtype, device, encoder_layers=W2V_LAYERS, dropout=0.1):
    """Wav2Vec2Config's defaults (12 layers, 768-d, 12 heads, FF 3072, relu,
    the 7-conv /320 extractor, conv positional embedding k=128 / 16 groups,
    2 x 320 codes, 100 negatives), random weights from SEED, the model's
    generators seeded from SEED as train.main seeds them."""
    from liteasr_tpu_torch.models.wav2vec2 import Wav2Vec2

    model = Wav2Vec2(encoder_layers=encoder_layers, dropout=dropout,
                     attention_dropout=dropout, dtype=dtype, device=device,
                     generator=torch.Generator().manual_seed(SEED))
    model.seed_dropout(SEED)
    return model


def w2v_overrides(wave_root, run, epochs):
    """tools/run_pretrain.sh's recipe (diversity 1.0, Adam lr 2e-4, clip 5,
    bf16) on phase a's raw-wave corpus."""
    return ["task=pretrain", "model=wav2vec2", "criterion=wav2vec", "optimizer=my_adam",
            "optimizer.lr=2e-4", "criterion.diversity_weight=1.0", "model.dtype=bfloat16",
            f"task.train={wave_root}/train", f"task.valid={wave_root}/valid",
            f"task.save_dir={run}/ckpts", f"common.run_dir={run}", f"common.seed={SEED}",
            f"optimization.max_epoch={epochs}", "optimization.accum_grad=1",
            "optimization.clip_grad_norm=5.0"]


def w2v_valid_lines(run):
    with open(os.path.join(run, "train.log")) as f:
        return [ln.split(" - ", 1)[-1].strip() for ln in f if "valid loss:" in ln]


def run_w2v_training(fa, root, wave_root, dev, name):
    """Phase u: task=pretrain through train.main at full width on phase a's
    corpus for W2V_EPOCHS epochs, then the same for 1 epoch and a
    ``common.resume=auto`` continuation, in torch's deterministic mode (the
    negatives' gather backward otherwise sums by atomics), whose last valid
    line must equal the uninterrupted run's. Returns the K1 launches of the
    uninterrupted run."""
    from liteasr_tpu_torch import train
    from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    run = os.path.join(root, "w2v_run")
    seen = []  # (train, loss, accuracy, code_ppl) of every criterion call
    call = Wav2Vec2Loss.__call__

    def record(self, model, batch, train=True):
        loss, aux = call(self, model, batch, train)
        seen.append((train, loss.item(), aux["accuracy"].item(), aux["code_ppl"].item()))
        return loss, aux

    Wav2Vec2Loss.__call__ = record
    try:
        reset_counts(fa)
        t0 = time.perf_counter()
        trainer = train.main(w2v_overrides(wave_root, run, W2V_EPOCHS), device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        fwd, lse, bwd = counts(fa)
        micro = W2V_EPOCHS * len(trainer.task.dataset("train"))
        n_valid = W2V_EPOCHS * len(trainer.valid_set)
        if (fwd, lse, bwd) != (W2V_LAYERS * n_valid, 0, 0):
            raise RuntimeError(f"wav2vec2 launches K1 {fwd - lse}, K1' {lse}, K2 {bwd} for "
                               f"{micro} micro-batches and {n_valid} valid batches, expected "
                               f"{W2V_LAYERS} K1 per valid batch and no K1'/K2")
        train_seen = [s[1:] for s in seen if s[0]]
        if len(train_seen) != micro or not np.isfinite(train_seen).all():
            raise RuntimeError(f"wav2vec2 training (loss, accuracy, code_ppl): {train_seen}")
        init = dict(build_w2v_model(torch.bfloat16, "cpu").named_parameters())
        moved = {n for n, p in trainer.model.named_parameters()
                 if not torch.equal(p.detach().cpu(), init[n])}
        if moved != set(init):
            raise RuntimeError(f"parameters that did not move: {sorted(set(init) - moved)}")
        lines = w2v_valid_lines(run)
        if (len(lines) != W2V_EPOCHS
                or not all(re.search(r"\| accuracy: \S+ \| code_ppl: \S+$", ln) for ln in lines)):
            raise RuntimeError(f"wav2vec2 valid lines: {lines}")
        ckpt = os.path.join(run, "ckpts", f"model.ep.{W2V_EPOCHS}.pt")
        if not os.path.isfile(ckpt):
            raise RuntimeError(f"{ckpt} was not written")
        shapes = sorted({tuple(trainer.task.dataset("train").collator(
            trainer.task.dataset("train")[i])["xs"].shape)
            for i in range(len(trainer.task.dataset("train")))})
        log(f"wav2vec2 train: {micro} micro-batches {shapes} in {W2V_EPOCHS} epochs, "
            f"{int(trainer.tx.count)} optimizer steps ({int(trainer.tx.notfinite_count)} "
            f"skipped), {secs:.2f} s incl. validation and checkpoints; (loss, accuracy, "
            f"code_ppl) {[tuple(round(x, 3) for x in s) for s in train_seen]}; K1 {fwd} "
            f"({W2V_LAYERS} per valid batch), K1' {lse}, K2 {bwd}; all {len(moved)} parameter "
            f"leaves ({sum(p.numel() for p in trainer.params)} parameters) moved "
            f"(quantizer.vars and mask_emb among them); {lines} [{name}]")
        params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        del trainer, init
        gc.collect()

        resumed_run = os.path.join(root, "w2v_resumed")
        train.main(w2v_overrides(wave_root, resumed_run, 1), device=dev)
        resumed = train.main(w2v_overrides(wave_root, resumed_run, W2V_EPOCHS)
                             + ["common.resume=auto"], device=dev)
        r_lines = w2v_valid_lines(resumed_run)
        diff = max((p - params[n]).abs().max().item()
                   for n, p in resumed.model.named_parameters())
        log(f"wav2vec2 resume: 1 epoch, then resume=auto to {W2V_EPOCHS}: last valid line "
            f"{r_lines[-1]!r} against the uninterrupted run's {lines[-1]!r}; parameters "
            f"max abs diff {diff:.3g} [{name}]")
        if len(r_lines) != W2V_EPOCHS or r_lines[-1] != lines[-1]:
            raise RuntimeError("the resumed wav2vec2 run's valid lines differ from the "
                               f"uninterrupted run's: {r_lines} vs {lines}")
        del resumed
    finally:
        Wav2Vec2Loss.__call__ = call
        torch.use_deterministic_algorithms(False)
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        gc.collect()
    return fwd


def w2v_step_flops(rows: int, samples: int) -> float:
    """Operations of one fwd+bwd micro-step of the base configuration (3x
    the forward's products): the conv stack, the conv positional embedding,
    the 12 transformer layers (projections, FF, both attention products),
    the input, final, quantizer and codebook projections, and the
    candidates' dot products."""
    from liteasr_tpu_torch.models.wav2vec2 import DEFAULT_CONV_LAYERS

    flops, t, c_in = 0.0, samples, 1
    for dim, k, s in eval(DEFAULT_CONV_LAYERS):  # noqa: S307
        t = (t - k) // s + 1
        flops += 2.0 * rows * t * dim * c_in * k
        c_in = dim
    n, d = rows * t, W2V_DIM
    flops += 2.0 * n * d * (d // 16) * 128  # pos_conv, 16 groups
    flops += W2V_LAYERS * (2.0 * n * 4 * d * d + 2.0 * n * 2 * d * 3072
                           + 2 * 2.0 * rows * t * t * d)
    flops += 2.0 * n * (c_in * d + d * d + c_in * 640 + 640 * 384 + d * d)
    flops += 2.0 * 101 * n * d
    return 3 * flops


def w2v_step_batch(dev):
    """The operating point: 23 utterances of 56,000 samples (the corpus's
    3.75 s mean crops to 56,000) + 1 weight-0 dummy row, as the collator
    pads them."""
    rng = np.random.default_rng(SEED + 12)
    rows, real = W2V_STEP_ROWS, W2V_STEP_ROWS - 1
    xs = (rng.normal(size=(rows, W2V_STEP_SAMPLES))
          * 10.0 ** rng.uniform(-2.5, -0.7, (rows, 1))).astype(np.float32)
    xs[real:] = 0.0
    xlens = np.array([W2V_STEP_SAMPLES] * real + [0], np.int64)
    valid = np.array([1.0] * real + [0.0], np.float32)
    return {"xs": torch.from_numpy(xs).to(dev), "xlens": torch.from_numpy(xlens).to(dev),
            "valid": torch.from_numpy(valid).to(dev)}, real


def time_w2v_step(dev, name):
    """Phase v: the micro-step at the operating point (bf16, dropout 0.1,
    diversity 1.0, Adam lr 2e-4, clip 5): 3 warm-up steps, the median of 5
    repetitions of 4, utt/s, peak memory and MFU against 989 TFLOP/s; 4
    more traced with device activity only (the busy share and the top
    device ops); then alone, fwd+bwd: the conv extractor, the conv
    positional embedding, and the negatives' gather with compute_logits;
    and the host's draws of one step."""
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss
    from torch.profiler import ProfilerActivity

    from liteasr_tpu_torch.models.wav2vec2 import conv_output_length, negative_indices
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(SEED)
    model = build_w2v_model(torch.bfloat16, dev)
    crit = Wav2Vec2Loss(DotDict(diversity_weight=1.0))
    params = list(model.parameters())
    tx = FusedAdam(params, constant_schedule(2e-4), 0.9, 0.999, 1e-8, clip=5.0)
    batch, real = w2v_step_batch(dev)
    count = [0]

    def step():
        loss, _ = crit(model, dict(batch, step=count[0]), train=True)
        count[0] += 1
        loss.backward()
        tx.update([p.grad for p in params])
        for p in params:
            p.grad = None
        return loss

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            loss = step()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 4)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite wav2vec2 loss in the timed steps")
    med = statistics.median(reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = w2v_step_flops(W2V_STEP_ROWS, W2V_STEP_SAMPLES)
    out = {"step_ms": med * 1e3, "utt_s": real / med, "peak_gib": peak,
           "mfu": flops / med / H100_BF16_PEAK}
    prof, wall_us, busy, ops = traced_steps(step, 4, [ProfilerActivity.CUDA])
    top = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    log(f"wav2vec2 device busy (4 micro-steps traced with device activity only): "
        f"{busy / 4e3:.2f} ms/micro-step of {wall_us / 4e3:.2f} ms traced wall = "
        f"{busy / wall_us:.1%}; {ops / 4:.0f} device ops/micro-step; top device time "
        f"a step: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 4e3:.2f} ms"
                                for e in top) + f" [{name}]")

    xs = batch["xs"]
    B, F, D = W2V_STEP_ROWS, conv_output_length(W2V_STEP_SAMPLES, model.conv_layers), W2V_DIM
    n1 = model.num_negatives + 1
    grad = torch.randn(B, F, model.conv_layers[-1][0], device=dev, dtype=torch.bfloat16)

    def extractor():
        model.feature_extractor(xs).backward(grad)

    out["extractor_ms"] = host_time_ms(extractor)
    h = torch.randn(B, F, D, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g_h = torch.randn(B, F, D, device=dev, dtype=torch.bfloat16)

    def pos_conv():  # the conv positional embedding and embed_norm
        model.encoder.embed(h).backward(g_h)

    out["pos_conv_ms"] = host_time_ms(pos_conv)
    for p in params:
        p.grad = None
    x = torch.randn(B, F, D, device=dev, dtype=torch.bfloat16, requires_grad=True)
    y = torch.randn(B, F, D, device=dev, dtype=torch.bfloat16, requires_grad=True)
    flens = model.feature_lengths(batch["xlens"])
    mask = model.draw_mask(B, F, flens, True)
    u = model.draw_negatives_uniform(B, F, True, dev)
    g_logits = torch.randn(n1, B, F, device=dev)

    def logits():
        idx = negative_indices(u, mask, flens)
        cand = torch.cat([torch.arange(F, device=dev)[None, :, None].expand(B, F, 1), idx],
                         2).reshape(B, -1)
        tgt = y[torch.arange(B, device=dev)[:, None], cand].reshape(B, F, n1, D)
        lg = model.compute_logits(x, tgt)
        lg.masked_fill(torch.isinf(lg), 0.0).backward(g_logits)

    out["logits_ms"] = host_time_ms(logits)

    def draws():
        model.draw_mask(B, F, flens, True)
        model.draw_negatives_uniform(B, F, True, dev)
        model.draw_gumbel_noise(B * F * 2, dev)

    out["draws_ms"] = host_time_ms(draws)
    out["skipped"] = int(tx.notfinite_count)
    log(f"wav2vec2 train step at the operating point ({W2V_STEP_ROWS} rows = {real} utts + 1 "
        f"dummy x {W2V_STEP_SAMPLES} samples, F={F}, bf16, dropout 0.1, diversity 1.0): median "
        f"{med * 1e3:.2f} ms/micro-step (best {min(reps) * 1e3:.2f}; 5 x 4 steps), "
        f"{real / med:.2f} utt/s, peak memory {peak:.2f} GiB, {flops / 1e12:.3f} TFLOP a step, "
        f"{out['skipped']} of {count[0]} updates skipped as non-finite (the dummy row at the "
        f"init's zero LayerNorm biases), "
        f"MFU {out['mfu']:.2%}; alone, fwd+bwd: conv extractor {out['extractor_ms']:.2f} ms "
        f"({out['extractor_ms'] / (med * 1e3):.1%} of the step), the conv positional "
        f"embedding {out['pos_conv_ms']:.2f} ms ({out['pos_conv_ms'] / (med * 1e3):.1%}), "
        f"negatives' gather + "
        f"compute_logits {out['logits_ms']:.2f} ms ({out['logits_ms'] / (med * 1e3):.1%}); the "
        f"host's draws (mask, negatives, Gumbel) {out['draws_ms']:.2f} ms [{name}]")
    del model, tx, params, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_w2v_parity(dev, name):
    """Phase w, fp32 (TF32 off): the base configuration with 2 encoder
    layers (the full conv stack, dropout 0) on the card against the CPU in
    fp64 at the same weights and draws, on 4 rows x 16,000 samples (two
    shorter): the eval loss, accuracy, code_ppl and -inf count, the count
    printed first; then one train step under the train-parity rule, the
    -inf count of the frames the loss weights printed first. No dummy row:
    at the init's zero LayerNorm biases, a dummy row's masked frame 0 sends
    the diversity term's gradient through 8 zero-variance LayerNorms, x1e6
    each (a reference behaviour), past fp32's range."""
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss, gumbel_temperature
    from liteasr_tpu_torch.trainer import to_device

    rng = np.random.default_rng(SEED + 13)
    batch = {"xs": (rng.normal(size=(4, 16000)) * 0.1).astype(np.float32),
             "xlens": np.array([16000, 14000, 12000, 16000], np.int64),
             "valid": np.ones(4, np.float32)}
    crit = Wav2Vec2Loss(DotDict(diversity_weight=1.0))
    res = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        model = build_w2v_model(dtype, device, encoder_layers=2, dropout=0.0).to(dtype)
        b = to_device(batch, device)
        b["xs"] = b["xs"].to(dtype)
        with torch.no_grad():
            logits, mask, _ = model(b["xs"], b["xlens"], train=False)
            loss, aux = crit(model, b, train=False)
        weight = (mask & (b["valid"][:, None] > 0)).cpu()
        ev = (int(torch.isneginf(logits).sum()), loss.item(), aux["accuracy"].item(),
              aux["code_ppl"].item(), float(weight.sum()))
        loss, aux = crit(model, dict(b, step=1000), train=True)
        loss.backward()
        with torch.no_grad():  # the step's forward again, at the same draws
            model.seed_dropout(SEED)
            logits, mask, _ = model(b["xs"], b["xlens"], train=True,
                                    temp=gumbel_temperature(model.latent_temp, 1000))
        w = (mask & (b["valid"][:, None] > 0)).cpu()
        tr_inf = int((torch.isneginf(logits).cpu() & w[None]).sum())
        res.append((ev, tr_inf, loss.item(),
                    {n: p.grad.double().cpu() for n, p in model.named_parameters()}))
        del model
    (g_ev, g_inf, g_loss, g_grads), (c_ev, c_inf, c_loss, c_grads) = res
    log(f"wav2vec2 parity fp32 card vs CPU fp64 (2 layers at full width, the full conv "
        f"stack, 4 rows x <= 16000 samples): eval -inf logits {g_ev[0]} vs {c_ev[0]}; loss "
        f"{g_ev[1]:.6f} vs {c_ev[1]:.6f}, accuracy {g_ev[2]:.6f} vs {c_ev[2]:.6f}, code_ppl "
        f"{g_ev[3]:.4f} vs {c_ev[3]:.4f}; train -inf logits at weighted frames {g_inf} vs "
        f"{c_inf} [{name}]")
    one_frame = 1.0 / max(c_ev[4], 1.0)
    if (g_ev[0] != c_ev[0] or abs(g_ev[1] - c_ev[1]) > PARITY_TOL * abs(c_ev[1])
            or abs(g_ev[2] - c_ev[2]) > one_frame / 2
            or abs(g_ev[3] - c_ev[3]) > PARITY_TOL * abs(c_ev[3]) or g_inf != c_inf):
        raise RuntimeError("wav2vec2 eval or train -inf logits differ between the card "
                           "and the CPU")
    what = grad_agreement(g_loss, g_grads, c_loss, c_grads)
    log(f"wav2vec2 train parity fp32 card vs CPU fp64 (step 1000, diversity 1.0): {what} "
        f"[{name}]")


# ------------------------------------- data parallelism on one card (x-y)


def free_address() -> str:
    """127.0.0.1 and a port the OS hands out (bound to 0, then released)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def dp_group(dev):
    """A process group of one rank on the card over NCCL (there is one
    H100: NCCL refuses two ranks on one device); returns ``parallel``."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict

    parallel.distributed_init(DotDict(coordinator_address=free_address(),
                                      num_processes=1, process_id=0), dev)
    if torch.distributed.get_backend() != "nccl":
        raise RuntimeError(f"backend {torch.distributed.get_backend()}, not nccl")
    return parallel


def run_dp_training(fa, root, dev, name, per_micro):
    """Phase x: my_U2 through train.main inside a one-rank NCCL group
    (``distributed.coordinator_address/num_processes/process_id``) on phase
    6's corpus for 1 epoch; K1'/K2 launches per micro-batch equal to phase
    6's (``per_micro``), the collectives counted by kind, finite losses,
    the valid line's aux keys; then ``infer.infer`` of the checkpoint inside
    a group (24 K1 launches per batch) and without one: the same error
    count and decoded pairs. Returns x's (K1, K1', K2) launches: the
    training run's and the grouped decode's."""
    from liteasr_tpu_torch import infer, parallel, train
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml

    run = os.path.join(root, "dp_run")
    overrides = train_overrides("u2", root, run, 1) + [
        f"distributed.coordinator_address={free_address()}",
        "distributed.num_processes=1", "distributed.process_id=0"]
    reset_counts(fa)
    parallel.counts.clear()
    t0 = time.perf_counter()
    trainer = train.main(overrides, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fwd, lse, bwd = counts(fa)
    coll = dict(parallel.counts)
    micro, n_valid = len(trainer.task.dataset("train")), len(trainer.valid_set)
    steps = int(trainer.tx.count) + int(trainer.tx.notfinite_count)
    if trainer.backend != "nccl" or trainer.world != 1 or parallel.is_initialized():
        raise RuntimeError(f"backend {trainer.backend}, world {trainer.world}; the "
                           "group must end with the run")
    if ((lse / micro, bwd / micro) != per_micro
            or fwd - lse != (ENC_LAYERS + 2 * DEC_LAYERS) * n_valid):
        raise RuntimeError(f"launches K1' {lse}, K2 {bwd}, K1 {fwd - lse} for {micro} "
                           f"micro-batches (phase 6: {per_micro} per micro-batch) and "
                           f"{n_valid} valid batches")
    want = {"grad": steps, "batch_norm": 2 * ENC_LAYERS * micro,
            "count": micro + n_valid, "metrics": 1, "gather": 1}
    if coll != want:
        raise RuntimeError(f"collectives {coll}, expected {want}")
    losses = torch.stack(trainer._loss_accum).float().cpu()
    if len(losses) != micro or not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"training losses {losses.tolist()}")
    with open(os.path.join(run, "train.log")) as f:
        valid = [ln for ln in f if "valid loss:" in ln]
    if len(valid) != 1 or not all(f"| {k}:" in valid[0]
                                  for k in ("ctc_infeasible", "loss_attn", "loss_ctc")):
        raise RuntimeError(f"valid lines {valid}")
    log(f"dp train (one-rank NCCL group): {micro} micro-batches, {steps} optimizer steps "
        f"in {secs:.2f} s incl. the group's start, validation and checkpoint; losses "
        f"{[round(x, 3) for x in losses.tolist()]}; K1' {lse}, K2 {bwd}, K1 {fwd - lse} "
        f"launches ({lse // micro} + {bwd // micro} per micro-batch, as phase 6); "
        f"collectives {coll} (BatchNorm: forward and backward of {ENC_LAYERS} layers "
        f"per micro-batch); {valid[0].split(' - ')[-1].strip()} [{name}]")

    results, pairs, dec = [], [], 0
    for grouped in (True, False):
        dump = os.path.join(run, f"decode_{grouped}.tsv")
        cfg = compose(["inference.ckpt_name=1", "inference.model_avg=false",
                       f"inference.batch_size={N_VALID}", f"inference.beam_size={BEAM}",
                       f"inference.dump={dump}"],
                      base=load_yaml(os.path.join(run, "config.yaml")))
        if grouped:
            dp_group(dev)
        try:
            reset_counts(fa)
            parallel.counts.clear()
            results.append(infer.infer(cfg, device=dev))
            torch.cuda.synchronize()
            gathered = parallel.counts["gather"]
        finally:
            parallel.destroy()
        if grouped:
            dec = counts(fa)[0]
            if dec != ENC_LAYERS + 2 * DEC_LAYERS or gathered != 0:
                raise RuntimeError(f"grouped decode: K1 {dec}, gathers {gathered}")
        with open(dump) as f:
            pairs.append(f.read())
    if results[0] != results[1] or pairs[0] != pairs[1]:
        raise RuntimeError(f"the checkpoint decodes differently in the group: {results}")
    log(f"dp decode of model.ep.1.pt inside the group: error count {results[0][0][0]}/"
        f"{results[0][0][1]}, K1 launches {dec}; the same {len(pairs[0].splitlines())} "
        f"decoded pairs as without a group [{name}]")
    return fwd + dec, lse, bwd


def step_model(family, dev):
    """The fp32 layout steps' model (2 encoder layers and 1 decoder or
    LSTM layer at ``family``'s full width, dropout 0, random weights from
    SEED) and its criterion."""
    from liteasr_tpu_torch.config.core import DotDict

    if family == "u2":
        from liteasr_tpu_torch.criterions.hybrid_ctc_attn import HybridCTCLoss

        return (build_model(torch.float32, dev, enc_layers=2, dec_layers=1),
                HybridCTCLoss(DotDict(vocab_size=VOCAB, padding_idx=-1, smoothing=0.1,
                                      ctc_weight=0.3)))
    if family == "rnnt":
        from liteasr_tpu_torch.criterions.rnnt import RNNTLoss

        return (build_td_model(torch.float32, dev, enc_layers=2, lstm_layers=1),
                RNNTLoss(DotDict(blank_id=0)))
    from liteasr_tpu_torch.criterions.paraformer_loss import ParaformerLoss

    return (build_para_model(torch.float32, dev, enc_layers=2, dec_layers=1),
            ParaformerLoss(DotDict(vocab_size=VOCAB, gamma=1.0)))


def dp_step(dev, shard=False, perturb=0.0, family="u2"):
    """Phase 8's fp32 step (2 + 1 layers at full width, dropout 0) of
    ``family`` (:func:`step_model`; the Paraformer glancing with a fresh
    model's noise, the same draws in every process): the loss, the flat
    gradient the optimizer takes (after its all-reduce, when a group is up)
    by leaf, and the BatchNorm running statistics. ``shard``: on this
    rank's tp/sp shard of the model (z3, z6, z9), the loss being the rank's
    share, the gradient and statistics gathered to the one-process layout.
    ``perturb``: the input features scaled by 1 + perturb (2**-23: moved by
    one or two ulps), the step's fp32 resolution."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.parallel import sharding
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule
    from liteasr_tpu_torch.trainer import to_device

    rng = np.random.default_rng(SEED + 2)
    B, T, U = 4, 400, 24
    batch = {"xs": rng.normal(size=(B, T, FEAT)).astype(np.float32),
             "xlens": np.array([T, 350, 280, 200], np.int32),
             "ys": rng.integers(1, VOCAB - 1, size=(B, U)).astype(np.int32),
             "ylens": np.array([U, 20, 16, 10], np.int32),
             "valid": np.ones(B, np.float32)}
    batch["xs"] = batch["xs"] * np.float32(1.0 + perturb)
    model, crit = step_model(family, dev)
    if shard:
        sharding.shard_model(model, parallel.layout())
    named = list(model.named_parameters())
    tx = FusedAdam([p for _, p in named], constant_schedule(0.0), 0.9, 0.999, 1e-8,
                   sharded=sharding.sharded_parameters(model))
    flat = []
    tx._step = flat.append  # the gradient the update takes
    loss, _ = crit(model, to_device(batch, dev), train=True)
    loss.backward()
    tx.update([p.grad for _, p in named])
    state = sharding.gather_state_dict(model)  # persistent buffers only
    buffers = [n for n, _ in model.named_buffers() if n in state]
    if not shard:
        grads = flat[0].split([p.numel() for _, p in named])
        return (loss.item(), {n: g.cpu() for (n, _), g in zip(named, grads)},
                {n: state[n] for n in buffers})
    shapes = [state[n].shape for n, _ in named]
    grads = sharding.gather_flat(flat[0], named).split([s.numel() for s in shapes])
    return (loss.item(), {n: g for (n, _), g in zip(named, grads)},
            {n: state[n] for n in buffers})


def leaf_diffs(ref, got):
    """{leaf: max abs diff over the leaf's max} of dp_step's gradients and
    BatchNorm statistics; the leaves whose gradient is 0 in exact
    arithmetic over the step's largest gradient, as in phase 8."""
    top = max(g.abs().max().item() for g in ref[1].values())
    out = {}
    for what, r, g in (("grad", ref[1], got[1]), ("stat", ref[2], got[2])):
        for n, c in r.items():
            zero = what == "grad" and n.endswith((".conv.depthwise_conv.bias",
                                                  ".linear_k.bias"))
            scale = top if zero else c.abs().max().item()
            out[f"{what} {n}"] = (g[n] - c).abs().max().item() / max(scale, 1e-30)
    return out


def check_dp_parity(dev, name):
    """Phase x, fp32 (TF32 off): the step inside a one-rank NCCL group
    against the same step without a group: the loss, every gradient leaf
    (the flat gradient after the optimizer's all-reduce) and the BatchNorm
    running statistics within 1e-5 of the leaf's own max. K2 sums dQ and dP
    by fp32 atomics in whatever order its blocks finish, so no two runs of
    a step on the card agree to the bit: two ungrouped runs show that floor
    (printed). The leaves whose gradient is 0 in exact arithmetic are held
    to the largest gradient, as in phase 8."""
    ref, again = dp_step(dev), dp_step(dev)
    parallel = dp_group(dev)
    try:
        parallel.counts.clear()
        got = dp_step(dev)
        coll = dict(parallel.counts)
    finally:
        parallel.destroy()
    if coll != {"grad": 1, "count": 1, "batch_norm": 4}:
        raise RuntimeError(f"collectives of the grouped step: {coll}")
    floor = leaf_diffs(ref, again)
    worst = sorted((e, n) for n, e in leaf_diffs(ref, got).items())
    bound = 1e-5
    loss_err = abs(got[0] - ref[0]) / abs(ref[0])
    log(f"dp step parity fp32 (2+1 layers at full width): loss {got[0]:.6f} vs "
        f"{ref[0]:.6f} (rel {loss_err:.3g}); collectives {coll}; worst of "
        f"{len(worst)} leaves (gradients and BatchNorm statistics) over their max: "
        f"{', '.join(f'{n} {e:.3g}' for e, n in worst[:-4:-1])}; two ungrouped runs "
        f"differ by up to {max(floor.values()):.3g} ({max(floor, key=floor.get)}); "
        f"bound {bound:.3g} [{name}]")
    if loss_err > 1e-5 or worst[-1][0] > bound:
        raise RuntimeError("the grouped step disagrees with the ungrouped one")


def time_dp_step(dev, name, plain_ms):
    """Phase y: the micro-step at bench.py's point (the optimizer's
    flat-gradient all-reduce hooked in) timed in turns without a group and
    inside a one-rank NCCL group, started afresh for each turn: 5 turns of
    10 micro-steps each way, after 2 warm-up steps, the medians against
    each other and against phase 7's ``plain_ms``; utt/s, peak memory; the
    collectives per micro-step by kind, the host's time inside them, and
    their NCCL kernels and device time in a trace of 10 micro-steps (device
    activity only); one flat all-reduce of the parameters alone, which in
    a one-rank group moves no bytes and launches no kernel: its time is the
    call's, not the cost of an all-reduce across cards."""
    from liteasr_tpu_torch import parallel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    dist = torch.distributed
    step, B = bench_step(dev)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        step()
    times = {False: [], True: []}
    for _ in range(5):
        for grouped in (False, True):
            if grouped:
                dp_group(dev)
            try:
                for _ in range(2):
                    step()
                torch.cuda.synchronize()
                parallel.counts.clear()
                t0 = time.perf_counter()
                for _ in range(10):
                    loss = step()
                torch.cuda.synchronize()
                times[grouped].append((time.perf_counter() - t0) / 10)
                per_step = {k: v / 10 for k, v in sorted(parallel.counts.items())}
            finally:
                parallel.destroy()
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite loss in the timed steps")
    med = {g: statistics.median(t) for g, t in times.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    dp_group(dev)
    try:
        all_reduce, host = dist.all_reduce, [0.0, 0]

        def timed(*args, **kw):  # the host's time inside each collective call
            t = time.perf_counter()
            out = all_reduce(*args, **kw)
            host[0] += time.perf_counter() - t
            host[1] += 1
            return out

        dist.all_reduce = timed
        try:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = all_reduce
        prof, wall_us, busy, ops = traced_steps(step, 10, [ProfilerActivity.CUDA])
        nccl = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and "nccl" in e.name.lower()]
        nccl_us = sum(e.time_range.end - e.time_range.start for e in nccl)
        n_params = sum(p.numel() for p in step.params)
        flat = torch.zeros(n_params, device=dev)
        noop_ms = cuda_time_ms(lambda: dist.all_reduce(flat), reps=10, inner=10)
    finally:
        parallel.destroy()
    log(f"dp micro-step at bench.py's point (B={B}, T=800, U=48, bf16, accum {ACCUM}), "
        f"5 turns of 10 each way: in a one-rank NCCL group median {med[True] * 1e3:.2f} ms "
        f"(best {min(times[True]) * 1e3:.2f}), without a group {med[False] * 1e3:.2f} ms "
        f"(best {min(times[False]) * 1e3:.2f}): {med[True] / med[False]:.3f}x; phase 7 "
        f"{plain_ms:.2f} ms; {B / med[True]:.2f} utt/s in the group; peak mem {peak:.2f} "
        f"GiB; collectives per micro-step {per_step}; host time inside them "
        f"{host[0] * 1e3 / 10:.3f} ms/micro-step ({host[1] / 10:.1f} calls); device: "
        f"{len(nccl) / 10:.1f} NCCL kernels, {nccl_us / 1e4:.4f} ms per micro-step of "
        f"{busy / 1e4:.2f} ms busy ({ops / 10:.0f} device ops); one flat all-reduce of "
        f"{n_params} fp32 ({4 * n_params / 2**20:.1f} MiB) alone in the one-rank group, "
        f"which moves no bytes, {noop_ms:.4f} ms (the call only; across cards: not "
        f"measured) [{name}]")
    return dict(step_ms=med[True] * 1e3, nogroup_ms=med[False] * 1e3,
                nccl_kernels=len(nccl) / 10, nccl_ms=nccl_us / 1e4, noop_ms=noop_ms,
                host_ms=host[0] * 1e3 / 10)


# ---- tensor and sequence parallelism (z1-z4) ----

TP_SP_CASES = (  # label: (head0, heads, q0, q1, chunk) at the training shape
    ("tp_h0", 0, 2, 0, TRAIN_T, 0), ("tp_h2", 2, 2, 0, TRAIN_T, 0),
    ("sp_q0", 0, HEADS, 0, 100, 0), ("sp_q100", 0, HEADS, 100, TRAIN_T, 0),
    ("sp_q0_chunk16", 0, HEADS, 0, 100, STATIC_CHUNK),
    ("sp_q100_chunk16", 0, HEADS, 100, TRAIN_T, STATIC_CHUNK))
TP_SP_LAYOUTS = ((1, 2), (2, 1))  # (sp, tp) of the 2 ranks that share the card
# z3's fp32 step in a tp or sp layout against one process, of each leaf's
# max. The layouts reorder sums (tp's row-parallel partial products, sp's
# time blocks), and this step resolves no better in fp32: moving its input
# by 1-2 ulps moves its leaves by up to 8.5e-5 of their max in one process,
# and the layouts read 7.6e-5 (tp) and 1.0e-4 (sp) on the card; in fp64 the
# layouts equal one process to ~1e-14 (tests/test_torch_tp.py,
# test_torch_sp.py). The bound is 3x the largest of these readings, and
# z3 plants layout faults (TP_SP_FAULTS) that it must catch. The loss is
# held to 1e-5.
TP_SP_TOL = 3e-4
TP_SP_LOSS_TOL = 1e-5
# z1: a shard against the rows and heads of the whole kernel call, which
# does the same arithmetic on them (K2's fp32 atomics sum dQ and dP in
# whatever order its blocks finish), absolute
SHARD_WHOLE_TOL = 1e-5


# the planted layout faults of z3, z6 and z9 (planted_fault) by family and
# layout, each of which the bound must catch: faults a tp or an sp layout
# of that family could really make
TP_SP_FAULTS = {
    ("u2", "tp"): ("batch_norm_count",),
    ("u2", "sp"): ("batch_norm_count", "conv_halo_frame"),
    ("rnnt", "tp"): ("linear_o_unreduced",),
    ("rnnt", "sp"): ("count_over_dpsp",),
    ("paraformer", "tp"): ("linear_o_unreduced",),
    ("paraformer", "sp"): ("count_over_dpsp",),
}
# linear_o_unreduced: the row-parallel layer whose all-reduce is dropped
UNREDUCED = {"rnnt": "encoder.layer_1.self_attn.linear_o",
             "paraformer": "decoder.layer_0.src_attn.linear_o"}


@contextlib.contextmanager
def planted_fault(kind, family="u2"):
    """One of the layout steps' negative controls, patched in for the steps
    inside: ``batch_norm_count`` counts one frame too many in every row of
    BatchNorm's statistics; ``conv_halo_frame`` zeroes the farthest of the
    7 frames of the depthwise conv's left halo on every sp rank but the
    first; ``linear_o_unreduced`` drops the tp all-reduce behind
    ``family``'s :data:`UNREDUCED` layer; ``count_over_dpsp`` reduces the
    criterion's utterance and token counts over dp x sp instead of dp."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.nets import layers
    from liteasr_tpu_torch.parallel import sharding

    if kind == "batch_norm_count":
        mod, attr, orig = layers, "train_batch_norm", layers.train_batch_norm

        def fault(x, gamma, beta, eps=1e-5, frames=None):
            return orig(x, gamma, beta, eps, (frames or x.shape[1]) + 1)
    elif kind == "conv_halo_frame":
        mod, attr, orig = sharding, "sp_halo", sharding.sp_halo

        def fault(x, pad, seq):
            y = orig(x, pad, seq)
            return y if seq.index == 0 else torch.cat([torch.zeros_like(y[:, :1]), y[:, 1:]], 1)
    elif kind == "linear_o_unreduced":
        mod, attr, orig = sharding, "shard_model", sharding.shard_model

        def fault(model, lay, model_cfg=None):
            model = orig(model, lay, model_cfg)
            model.get_submodule(UNREDUCED[family]).tp_reduce = False
            return model
    else:
        mod, attr, orig = parallel, "global_sum", parallel.global_sum

        def fault(*xs, kind="count", over="dp"):
            return orig(*xs, kind=kind, over="dpsp" if kind == "count" else over)
    setattr(mod, attr, fault)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def shard_inputs(x, head0, heads, q0, q1):
    """A shard's inputs cut from the whole call's ``x`` (train_slice_inputs):
    heads head0.. of each batch row, queries q0:q1 with the next block's
    first q_v row; and the whole call's rows it holds."""
    rows = torch.tensor([b * HEADS + h for b in range(TRAIN_BH // HEADS)
                         for h in range(head0, head0 + heads)], device=x["q_u"].device)
    out = {n: x[n][rows] for n in ("q_u", "qv", "k", "v", "kv_lens", "dout")}
    out["q_u"], out["dout"] = out["q_u"][:, q0:q1].contiguous(), out["dout"][:, q0:q1].contiguous()
    out["qv"] = out["qv"][:, q0:q1 + (q1 < TRAIN_T)].contiguous()
    out["p"] = x["p"][head0:head0 + heads].contiguous()
    return out, rows


def kernel_keep(fa, bh, tq, tqv, heads, shard, dev):
    """The (BH, Tq, T') keep mask that K1' (bf16, dropout TRAIN_RATE, seed
    TRAIN_SEED) draws at ``shard``, read off the kernel itself: with zero
    scores every key weighs 1/T', and V = the unit vectors of one block of
    64 keys at a time makes out[t, d] nonzero iff key 64 g + d is kept."""
    d, t = TRAIN_D, TRAIN_T
    z = dict(dtype=torch.bfloat16, device=dev)
    q, qv, k = (torch.zeros(bh, n, d, **z) for n in (tq, tqv, t))
    p = torch.zeros(heads, t, d, **z)
    keep = []
    for g in range(0, t, d):
        j = torch.arange(g, min(t, g + d), device=dev)
        v = torch.zeros(bh, t, d, **z)
        v[:, j, j - g] = 1.0
        out = fa.flash_attention(q, k, v, rel_qv=qv, rel_p=p, scale=1.0, return_lse=True,
                                 dropout_rate=TRAIN_RATE, dropout_seed=TRAIN_SEED,
                                 shard=shard)[0]
        keep.append(out[:, :, :len(j)] != 0)
    return torch.cat(keep, dim=-1)


def check_shard_kernels(fa, dev, name):
    """Phase z1: K1' and K2 in bf16 at the training shape on the shards
    that tp = 2 (BH = 64 of 128, head0 0 or 2) and sp = 2 (100 / 99 of
    T' = 199 queries, q0 0 or 100, with the next block's first q_v row; also
    under chunk 16) give them, dropout 0.1, a kv_len = 0 row: against the
    plain versions at the same offsets (phase 3's tolerances), against the
    rows and heads of the whole kernel call (the halo's dQ_v row included),
    the keep mask read off the kernel bit-equal to the whole call's slice
    and to dropout_keep_global's; K1 at the sp offsets against the plain
    version (validation's call); each call timed beside its bound over the
    live scores and the plain version. Returns the report by case."""
    gen = torch.Generator().manual_seed(SEED + 9)
    scale = TRAIN_D ** -0.5
    x = train_slice_inputs(gen, dev, torch.bfloat16, TRAIN_BH, TRAIN_T)
    ftol, gtol = KERNEL_TOL[torch.bfloat16], GRAD_TOL[torch.bfloat16]
    full_keep = kernel_keep(fa, TRAIN_BH, TRAIN_T, TRAIN_T, HEADS, fa.WHOLE, dev)
    if not torch.equal(full_keep, fa.dropout_keep_global(TRAIN_BH, TRAIN_T, TRAIN_T, TRAIN_SEED,
                                                         TRAIN_RATE, dev)):
        raise RuntimeError("the whole call's kernel keep mask is not dropout_keep_global's")
    rep = {"fwd_err": 0.0, "bwd_err": 0.0}
    for label, head0, heads, q0, q1, chunk in TP_SP_CASES:
        sx, rows = shard_inputs(x, head0, heads, q0, q1)
        shard = fa.Shard(q0=q0, t_q=TRAIN_T, head0=head0, h_local=heads, h_total=HEADS)
        ins = [sx[n] for n in ("q_u", "qv", "k", "v", "p")]
        kv, dout = sx["kv_lens"], sx["dout"]

        def fwd(plain=False, ins=ins, kv=kv, shard=shard, chunk=chunk, lse=True):
            f = fa.flash_attention_plain if plain else fa.flash_attention
            return f(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4],
                     scale=scale, return_lse=lse, dropout_rate=TRAIN_RATE if lse else 0.0,
                     dropout_seed=TRAIN_SEED, chunk=chunk, shard=shard)

        def bwd(out, lse, plain=False, ins=ins, kv=kv, dout=dout, shard=shard, chunk=chunk):
            f = fa.flash_rel_attention_bwd_plain if plain else fa.flash_rel_attention_bwd
            return f(*ins, kv, out, lse, dout, scale, TRAIN_RATE, TRAIN_SEED, chunk, shard)

        out, lse = fwd()
        ref_out, ref_lse = fwd(plain=True)
        out32 = out.float()
        grads, ref_grads = bwd(out32, lse), bwd(out32, ref_lse, plain=True)
        # the whole call with the shard's cotangent: its rows and heads
        wout, wlse = fa.flash_attention(
            x["q_u"], x["k"], x["v"], kv_lens=x["kv_lens"], rel_qv=x["qv"], rel_p=x["p"],
            scale=scale, return_lse=True, dropout_rate=TRAIN_RATE, dropout_seed=TRAIN_SEED,
            chunk=chunk)
        wdout = torch.zeros_like(x["dout"])
        wdout[rows[:, None], torch.arange(q0, q1, device=dev)] = dout
        wgrads = fa.flash_rel_attention_bwd(
            x["q_u"], x["qv"], x["k"], x["v"], x["p"], x["kv_lens"], wout.float(), wlse,
            wdout, scale, TRAIN_RATE, TRAIN_SEED, chunk)
        k1 = fwd(lse=False)
        k1_ref = fwd(plain=True, lse=False)
        wk1 = fa.flash_attention(x["q_u"], x["k"], x["v"], kv_lens=x["kv_lens"], rel_qv=x["qv"],
                                 rel_p=x["p"], scale=scale, chunk=chunk)
        torch.cuda.synchronize()
        live = kv > 0
        q1v = q1 + (q1 < TRAIN_T)
        errs = {"out": (out32 - ref_out.float()).abs().max().item(),
                "lse": (lse[live] - ref_lse[live]).abs().max().item(),
                "k1": (k1.float() - k1_ref.float()).abs().max().item()}
        ok = (within(out, ref_out, ftol) and within(lse[live], ref_lse[live], ftol)
              and within(k1, k1_ref, ftol) and bool((lse[~live] == fa.NEG_INF).all()))
        # the shard against the rows and heads of the whole call
        wlse = wlse[rows][:, q0:q1]
        whole = {"out": (out32, wout[rows][:, q0:q1].float()),
                 "lse": (lse[live], wlse[live]),
                 "k1": (k1.float(), wk1[rows][:, q0:q1].float())}
        ok = ok and bool((wlse[~live] == fa.NEG_INF).all())
        wg = (wgrads[0][rows][:, q0:q1], wgrads[1][rows][:, q0:q1v], wgrads[2][rows],
              wgrads[3][rows], wgrads[4][head0:head0 + heads])
        for gname, g, r, w in zip(("dq_u", "dqv", "dk", "dv", "dp"), grads, ref_grads, wg):
            errs[gname] = (g.to(torch.bfloat16).float() - r).abs().max().item()
            ok = ok and within(g.to(torch.bfloat16), r, gtol)
            whole[gname] = (g, w)
        if q1 < TRAIN_T:  # the halo: the next block's first q_v row, owned there
            whole["dqv_halo"] = (grads[1][:, -1], wgrads[1][rows][:, q1])
        for wname, (a, b) in whole.items():
            errs[f"{wname}_whole"] = (a - b).abs().max().item()
        if not ok or max(errs[f"{w}_whole"] for w in whole) > SHARD_WHOLE_TOL:
            raise RuntimeError(f"K1/K1'/K2 at {label}: {errs} beyond {ftol}/{gtol} against "
                               f"the plain versions or {SHARD_WHOLE_TOL} against the whole call")
        keep = kernel_keep(fa, len(rows), q1 - q0, q1v - q0, heads, shard, dev)
        if not (torch.equal(keep, full_keep[rows][:, q0:q1]) and torch.equal(
                keep, fa.dropout_keep_global(len(rows), q1 - q0, TRAIN_T, TRAIN_SEED,
                                             TRAIN_RATE, dev, shard))):
            raise RuntimeError(f"the keep mask at {label} is not the whole call's slice")
        r = {"lse_ms": cuda_time_ms(fwd), "bwd_ms": cuda_time_ms(lambda: bwd(out32, lse)),
             "k1_ms": cuda_time_ms(lambda: fwd(lse=False)),
             "lse_plain_ms": cuda_time_ms(lambda: fwd(plain=True), reps=5),
             "bwd_plain_ms": cuda_time_ms(lambda: bwd(out32, ref_lse, plain=True), reps=5),
             "k1_plain_ms": cuda_time_ms(lambda: fwd(plain=True, lse=False), reps=5)}
        r["lse_bound_ms"], r["lse_bound_by"] = fwd_bound(
            ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4], lse=True,
            chunk=chunk, q0=q0)
        r["k1_bound_ms"], r["k1_bound_by"] = fwd_bound(
            ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1], rel_p=ins[4], chunk=chunk, q0=q0)
        r["bwd_bound_ms"], r["bwd_bound_by"] = bwd_bound(*ins, kv, out32, lse, dout, chunk, q0)
        rep[label] = r
        rep["fwd_err"] = max(rep["fwd_err"], errs["out"], errs["lse"], errs["k1"])
        rep["bwd_err"] = max(rep["bwd_err"], *(errs[g] for g in ("dq_u", "dqv", "dk", "dv", "dp")))
        log(f"K1/K1'/K2 at {label} (BH={len(rows)} of {TRAIN_BH}, heads {head0}.."
            f"{head0 + heads} of {HEADS}, queries {q0}..{q1} of {TRAIN_T}, q_v rows "
            f"{q1v - q0}, chunk {chunk}) bf16: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
            + f" (tol {ftol}/{gtol} against plain, {SHARD_WHOLE_TOL} against the whole "
            f"call); keep mask bit-equal to the whole call's; K1' "
            f"{r['lse_ms']:.4f} ms (plain {r['lse_plain_ms']:.4f}, bound {r['lse_bound_ms']:.4f} "
            f"{r['lse_bound_by']}), K2 {r['bwd_ms']:.4f} ms (plain {r['bwd_plain_ms']:.4f}, "
            f"bound {r['bwd_bound_ms']:.4f} {r['bwd_bound_by']}), K1 {r['k1_ms']:.4f} ms "
            f"(plain {r['k1_plain_ms']:.4f}, bound {r['k1_bound_ms']:.4f}) [{name}]")
    return rep


def check_para_shard_kernels(fa, dev, name):
    """Phase z1, the Paraformer's pass 1 under tp = 2: K1 in bf16 at the
    rank's heads (head0 0 or 2, 2 of 4: BH = 64 of 128) of the two pass-1
    calls at bench.py's point (self-attention 48 x 48 without a mask, source
    attention 48 x 199 with kv_lens; phase o's whole calls): against the
    plain version at the same offset (phase o's tolerance) and against the
    heads of the whole kernel call (SHARD_WHOLE_TOL), each timed beside its
    bound, the plain version and one SDPA call on the shard. Returns the
    report by case and the largest error against the plain version."""
    shapes = para_kernel_shapes(torch.Generator().manual_seed(SEED + 7), dev, torch.bfloat16)
    tol = KERNEL_TOL[torch.bfloat16]
    rep = {"max_abs_err": 0.0}
    for shape in ("pass1_self", "pass1_src_kv_lens"):
        args = shapes[shape]
        scale = args["q"].shape[-1] ** -0.5
        whole = fa.flash_attention(scale=scale, **args)
        for head0 in (0, 2):
            rows = torch.tensor([b * HEADS + h for b in range(args["q"].shape[0] // HEADS)
                                 for h in range(head0, head0 + 2)], device=dev)
            cut = {k: v[rows] for k, v in args.items()}
            shard = fa.Shard(head0=head0, h_local=2, h_total=HEADS)
            out = fa.flash_attention(scale=scale, shard=shard, **cut)
            ref = fa.flash_attention_plain(scale=scale, shard=shard, **cut)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            whole_err = (out.float() - whole[rows].float()).abs().max().item()
            label = f"{shape}_h{head0}"
            if not within(out, ref, tol) or whole_err > SHARD_WHOLE_TOL:
                raise RuntimeError(f"K1 at the Paraformer's {label}: {err:.3g} against the "
                                   f"plain version (tol {tol}), {whole_err:.3g} against the "
                                   f"whole call (tol {SHARD_WHOLE_TOL})")
            r = {"ms": cuda_time_ms(lambda: fa.flash_attention(scale=scale, shard=shard, **cut)),
                 "plain_ms": cuda_time_ms(
                     lambda: fa.flash_attention_plain(scale=scale, shard=shard, **cut)),
                 "library_ms": cuda_time_ms(library_call(cut, scale))}
            r["bound_ms"], r["bound_by"] = fwd_bound(**cut)
            rep[label] = r
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            log(f"K1 at the Paraformer's pass 1 under tp=2, {shape} heads {head0}..{head0 + 2} "
                f"of {HEADS} (shape={tuple(cut['q'].shape)}x{cut['k'].shape[1]}) bf16: "
                f"max_abs_err={err:.3g} against plain (tol {tol}), {whole_err:.3g} against "
                f"the whole call (tol {SHARD_WHOLE_TOL}); kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library (SDPA) {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{name}]")
    return rep


def check_w2v_shard_kernels(fa, dev, name):
    """Phase z1, wav2vec 2.0's validation under tp = 2 and sp = 2: K1 in bf16
    at t's two shapes (W2V_SHAPES, no mask) on a tp rank's heads (head0 0
    or 6, 6 of 12: half the rows) and on an sp rank's block of the queries
    over all the keys (q0 0 or the first block's length): against the plain
    version at the same offset (t's tolerance) and against the rows and
    heads of the whole kernel call (SHARD_WHOLE_TOL), each timed beside its
    bound, the plain version and one SDPA call on the shard. Returns the
    report by case and the largest error against the plain version."""
    from liteasr_tpu_torch.parallel.sharding import split_sizes

    shapes = w2v_kernel_shapes(torch.Generator().manual_seed(SEED + 11), dev, torch.bfloat16)
    tol = KERNEL_TOL[torch.bfloat16]
    heads = W2V_HEADS // 2
    rep = {"max_abs_err": 0.0}
    for shape, args in shapes.items():
        scale = args["q"].shape[-1] ** -0.5
        whole = fa.flash_attention(scale=scale, **args)
        bh, t = args["q"].shape[:2]
        cases = []
        for head0 in (0, heads):
            rows = torch.tensor([b * W2V_HEADS + h for b in range(bh // W2V_HEADS)
                                 for h in range(head0, head0 + heads)], device=dev)
            cases.append((f"tp_h{head0}", {k: v[rows] for k, v in args.items()},
                          fa.Shard(head0=head0, h_local=heads, h_total=W2V_HEADS),
                          whole[rows], 0))
        lo = 0
        for n in split_sizes(t, 2):
            cases.append((f"sp_q{lo}", dict(args, q=args["q"][:, lo:lo + n].contiguous()),
                          fa.Shard(q0=lo, t_q=t), whole[:, lo:lo + n], lo))
            lo += n
        for case, cut, shard, in_whole, q0 in cases:
            out = fa.flash_attention(scale=scale, shard=shard, **cut)
            ref = fa.flash_attention_plain(scale=scale, shard=shard, **cut)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            whole_err = (out.float() - in_whole.float()).abs().max().item()
            label = f"{shape}_{case}"
            if not within(out, ref, tol) or whole_err > SHARD_WHOLE_TOL:
                raise RuntimeError(f"K1 at wav2vec 2.0's {label}: {err:.3g} against the "
                                   f"plain version (tol {tol}), {whole_err:.3g} against the "
                                   f"whole call (tol {SHARD_WHOLE_TOL})")
            r = {"ms": cuda_time_ms(lambda: fa.flash_attention(scale=scale, shard=shard, **cut)),
                 "plain_ms": cuda_time_ms(
                     lambda: fa.flash_attention_plain(scale=scale, shard=shard, **cut)),
                 "library_ms": cuda_time_ms(library_call(cut, scale))}
            r["bound_ms"], r["bound_by"] = fwd_bound(**cut, q0=q0)
            rep[label] = r
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            log(f"K1 at wav2vec 2.0's validation under {case[:2]}=2, {shape} {case} "
                f"(shape={tuple(cut['q'].shape)}x{cut['k'].shape[1]}, {shard}) bf16: "
                f"max_abs_err={err:.3g} against plain (tol {tol}), {whole_err:.3g} against "
                f"the whole call (tol {SHARD_WHOLE_TOL}); kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library (SDPA) {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{name}]")
    return rep


# ---- the exported decode program (e1) ----

# the JAX export CLI's default bucket (liteasr_tpu/export.py:137-138)
EXPORT_BATCH, EXPORT_FRAMES = 16, 1600


def export_worker(out):
    """Phase e1's process (``--export-worker OUT``), started after the
    kernel build so that its host-bound export and load overlap the other
    phases: my_U2 at full width (bf16, random weights from SEED) exported
    through ``export.export_decode`` in attention_rescore mode (beam 10,
    CTC weight 0.5) at 16 x 1600 x 80, traced on the card, saved to bytes
    and loaded; then, once ``OUT.go`` exists (the other phases are done,
    so the card is free), run on the card: its graph holds one K1 node per
    K1 call (24), its run launches the CUDA K1 24 times and gives the live
    pipeline's tokens and lengths exactly on a random batch (lengths
    1000-1600), and its time stands beside the live pipeline's (host clock,
    informational: the loaded program runs through the fx interpreter, one
    Python call per node). Writes the report to OUT as JSON."""
    from liteasr_tpu_torch import decode, export
    from liteasr_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    name = card()
    model = build_model(torch.bfloat16, dev)
    state = model.state_dict()
    rng = np.random.default_rng(SEED + 21)
    xs = torch.from_numpy(rng.normal(size=(EXPORT_BATCH, EXPORT_FRAMES, FEAT))
                          .astype(np.float32)).to(dev)
    lens = rng.integers(MIN_T, MAX_T + 1, EXPORT_BATCH)
    lens[0] = EXPORT_FRAMES
    xlens = torch.from_numpy(lens).to(dev)
    t0 = time.perf_counter()
    blob = export.export_decode(model, state, mode="attention_rescore", beam_size=BEAM,
                                ctc_weight=CTC_WEIGHT, batch=EXPORT_BATCH,
                                frames=EXPORT_FRAMES, feat_dim=FEAT, platforms="cuda")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = export.load_exported(blob)
    load_s = time.perf_counter() - t0
    nodes = export.count_nodes(run.program)
    per_batch = ENC_LAYERS + 2 * DEC_LAYERS
    if nodes != per_batch:
        raise RuntimeError(f"the exported program holds {nodes} K1 nodes, expected {per_batch}")
    while not os.path.exists(out + ".go"):  # the card's other phases first
        time.sleep(0.5)
    live = decode.decode_pipeline(model, "attention_rescore", BEAM, CTC_WEIGHT)
    with torch.inference_mode():
        want = live(xs, xlens)
    torch.cuda.synchronize()
    reset_counts(fa)
    got = run(state, xs, xlens)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    if launches != per_batch:
        raise RuntimeError(f"the loaded program launched K1 {launches} times, expected "
                           f"{per_batch}")
    if len(got) != 2 or not all(torch.equal(w, g) for w, g in zip(want, got)):
        raise RuntimeError("the exported program's hypotheses differ from the live pipeline's")

    def host_s(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def live_run():
        with torch.inference_mode():
            live(xs, xlens)

    prog_s, live_s = host_s(lambda: run(state, xs, xlens)), host_s(live_run)
    n_nodes = len(run.program.graph.nodes)
    log(f"export e1: my_U2 attention_rescore at {EXPORT_BATCH} x {EXPORT_FRAMES} x {FEAT} "
        f"(bf16, random weights): export + save {export_s:.2f} s, {len(blob)} bytes, "
        f"{n_nodes} graph nodes of which {nodes} liteasr::rel_attention_fwd; load "
        f"{load_s:.2f} s (both in a process of their own, beside the other phases); the "
        f"loaded program on the card: {launches} K1 launches a batch, tokens and lengths "
        f"equal to the live pipeline's; {prog_s:.3f} s a batch against the live "
        f"pipeline's {live_s:.3f} s (host clock, informational) [{name}]")
    with open(out, "w") as f:
        json.dump(dict(export_s=export_s, load_s=load_s, bytes=len(blob), nodes=nodes,
                       graph_nodes=n_nodes, launches=launches, program_s=prog_s,
                       live_s=live_s), f)


def start_export(root):
    """Start phase e1's process (:func:`export_worker`); returns (process,
    report path)."""
    out = os.path.join(root, "export_e1.json")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--export-worker", out],
                            env=dict(os.environ, PYTHONPATH=REPO))
    return proc, out


def finish_export(proc, out, timeout=900):
    """Let phase e1's process use the card and wait for its report."""
    with open(out + ".go", "w"):
        pass
    try:
        code = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if code != 0:
        raise RuntimeError(f"phase e1's process exited with {code}")
    with open(out) as f:
        return json.load(f)


# the families that the 2-rank phases run, in turn: U2 (z2-z4), the
# transducer (z5-z7), the Paraformer (z8-z10)
TP_SP_FAMILIES = ("u2", "rnnt", "paraformer")
FAMILY_NAMES = {"u2": "U2", "rnnt": "transducer", "paraformer": "Paraformer"}
# the inference trigger's decode mode (the Paraformer decodes by CIF in any)
FAMILY_MODES = {"u2": ["inference.mode=ctc_greedy"],
                "rnnt": ["inference.mode=transducer_greedy"], "paraformer": []}


def family_k1(family, micro, n_valid):
    """K1 (not K1') launches a rank makes in z2/z5/z8's training run of
    ``micro`` micro-batches and ``n_valid`` valid batches, with one decode
    batch from the inference trigger: the Paraformer's pass 1 (self and
    source per decoder layer) in every micro-batch; the encoder's and the
    decoders' in a valid batch; the encoder's (and the Paraformer's
    decoder's) in a decode batch."""
    if family == "u2":
        return (ENC_LAYERS + 2 * DEC_LAYERS) * n_valid + ENC_LAYERS
    if family == "rnnt":
        return TD_ENC_LAYERS * (n_valid + 1)
    return (2 * DEC_LAYERS * micro + (ENC_LAYERS + 4 * DEC_LAYERS) * n_valid
            + ENC_LAYERS + 2 * DEC_LAYERS)


def tp_sp_family(family, rank, sp, tp, addrs, root, dev, fa):
    """One rank's part of one family's 2-rank phases: the training run
    through train.main in a gloo group started here (the port joins it),
    every K1' / K2 call's shapes and, for each micro-batch, its rows and K1
    calls recorded; then, in a second group, the fp32 step and each planted
    fault's, and the bf16 micro-step at bench.py's point timed with the
    rank's peak memory."""
    from liteasr_tpu_torch import parallel, train
    from liteasr_tpu_torch import trainer as trainer_mod

    dist = torch.distributed
    calls, steps = [], []  # (kind, q, q_v, shard); (rows, [(q, shard) of K1])
    launch_fwd, launch_bwd = fa._launch_fwd, fa._launch_bwd
    train_step = trainer_mod.Trainer.train_step

    def rec_fwd(q, k, v, mask, kv_lens, rel_qv, rel_p, scale, return_lse, *a):
        if return_lse:
            calls.append(("K1'", tuple(q.shape), tuple(rel_qv.shape), a[-1]))
        elif steps and steps[-1][2]:
            steps[-1][1].append((tuple(q.shape), a[-1]))
        return launch_fwd(q, k, v, mask, kv_lens, rel_qv, rel_p, scale, return_lse, *a)

    def rec_bwd(q_u, qv, *a):
        calls.append(("K2", tuple(q_u.shape), tuple(qv.shape), a[-1]))
        return launch_bwd(q_u, qv, *a)

    def rec_step(self, batch):
        steps.append([batch["xs"].shape[0], [], True])
        try:
            return train_step(self, batch)
        finally:
            steps[-1][2] = False

    dist.init_process_group("gloo", init_method=f"tcp://{addrs[0]}", world_size=2, rank=rank)
    run = os.path.join(root, f"tpsp_{family}_sp{sp}_tp{tp}")
    overrides = train_overrides(family, root, run, 1) + FAMILY_MODES[family] + [
        f"distributed.coordinator_address={addrs[0]}", "distributed.num_processes=2",
        f"distributed.process_id={rank}", f"distributed.sp={sp}", f"distributed.tp={tp}",
        f"inference.batch_size={N_VALID}",
        "common.trigger=[{name: valid, interval: 1, unit: epoch}, "
        "{name: save_model, interval: 1, unit: epoch}, "
        "{name: inference, interval: 1, unit: epoch}]"]
    reset_counts(fa)
    reset_dp_counts()
    parallel.counts.clear()
    fa._launch_fwd, fa._launch_bwd = rec_fwd, rec_bwd
    trainer_mod.Trainer.train_step = rec_step
    try:
        t0 = time.perf_counter()
        trainer = train.main(overrides, device=dev)  # joins this group, ends it
        torch.cuda.synchronize()
    finally:
        fa._launch_fwd, fa._launch_bwd = launch_fwd, launch_bwd
        trainer_mod.Trainer.train_step = train_step
    res = dict(train_s=time.perf_counter() - t0, counts=counts(fa), dp_counts=dp_counts(),
               collectives=dict(parallel.counts), calls=calls,
               steps=[(rows, k1) for rows, k1, _ in steps],
               micro=len(trainer.task.dataset("train")), n_valid=len(trainer.valid_set),
               losses=[float(x) for x in trainer._loss_accum],
               backend=trainer.backend, layout=trainer.layout, run=run)
    del trainer

    dist.init_process_group("gloo", init_method=f"tcp://{addrs[1]}", world_size=2, rank=rank)
    parallel.distributed_init(dict(coordinator_address=addrs[1], num_processes=2,
                                   process_id=rank, sp=sp, tp=tp), dev)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["step"] = dp_step(dev, shard=True, family=family)
        res["faults"] = {}
        for fault in TP_SP_FAULTS[family, "sp" if sp > 1 else "tp"]:
            with planted_fault(fault, family):
                res["faults"][fault] = dp_step(dev, shard=True, family=family)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if family == "u2":
            step, B = bench_step(dev, shard=True)
        elif family == "rnnt":
            step, _, _, B = td_bench_step(dev, shard=True)
        else:
            step, B = para_bench_step(dev, shard=True)
        reset_dp_counts()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        parallel.counts.clear()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 5)
        res.update(step_ms=statistics.median(times) * 1e3, step_loss=loss.item(), step_rows=B,
                   step_dp_counts=dp_counts(),
                   step_collectives={k: v / 15 for k, v in parallel.counts.items()},
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del step, loss
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        parallel.destroy()
    return res


# wav2vec 2.0's planted layout faults (z12): under tp the diversity term and
# code_ppl divided by the process count (tp peers counted as shares), under
# sp the positional conv's halo zeroed (each rank padding its block)
W2V_TP_SP_FAULTS = {"tp": "diversity_world", "sp": "pos_conv_halo"}


@contextlib.contextmanager
def planted_w2v_fault(kind):
    """:data:`W2V_TP_SP_FAULTS`' ``kind`` patched in for the steps inside
    (tests/torch_dp_worker.py plants them too)."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.criterions import wav2vec_loss
    from liteasr_tpu_torch.parallel import sharding

    if kind == "diversity_world":
        mod, attr, fault = wav2vec_loss, "term_shares", parallel.process_count
    else:
        halo = sharding.sp_halo

        def fault(x, pad, seq):
            y = halo(x, pad, seq).clone()
            y[:, :pad] = 0.0
            y[:, y.shape[1] - pad:] = 0.0
            return y

        mod, attr = sharding, "sp_halo"
    saved = getattr(mod, attr)
    setattr(mod, attr, fault)
    try:
        yield
    finally:
        setattr(mod, attr, saved)


def w2v_layout_step(dev, shard=False, perturb=0.0):
    """z12's fp32 step of wav2vec 2.0 (2 encoder layers at full width,
    dropout 0, diversity 1.0) on 4 utterances of 32,000-48,000 samples with
    no dummy row, so that its update is applied: the loss, the flat
    gradient the optimizer takes (after its all-reduce) by leaf, and no
    statistics. The draws are the model's own streams, the one-process
    streams on every rank of a dp = 1 layout. ``shard``: on this rank's tp/sp
    shard, the loss its share, the gradient gathered to the one-process
    layout. ``perturb``: the waves scaled by 1 + perturb. Raises if the
    step is not applied (a non-finite gradient)."""
    from liteasr_tpu_torch import parallel
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule
    from liteasr_tpu_torch.parallel import sharding

    rng = np.random.default_rng(SEED + 13)
    B, S = 4, 48000
    xs = (rng.normal(size=(B, S)) * 10.0 ** rng.uniform(-2.5, -0.7, (B, 1))).astype(np.float32)
    batch = {"xs": torch.from_numpy(xs * np.float32(1.0 + perturb)).to(dev),
             "xlens": torch.tensor([S, 44000, 40000, 32000], device=dev),
             "valid": torch.ones(B, device=dev), "step": 0}
    model = build_w2v_model(torch.float32, dev, encoder_layers=2, dropout=0.0)
    crit = Wav2Vec2Loss(DotDict(diversity_weight=1.0))
    if shard:
        sharding.shard_model(model, parallel.layout())
    named = list(model.named_parameters())
    tx = FusedAdam([p for _, p in named], constant_schedule(0.0), 0.9, 0.999, 1e-8,
                   sharded=sharding.sharded_parameters(model))
    flat = []
    tx._step = flat.append  # the gradient the update takes
    loss, _ = crit(model, batch, train=True)
    loss.backward()
    tx.update([p.grad for _, p in named])
    if not (flat and bool(torch.isfinite(flat[0]).all())):
        raise RuntimeError("the wav2vec 2.0 layout step's update would be skipped")
    if not shard:
        grads = flat[0].split([p.numel() for _, p in named])
        return loss.item(), {n: g.cpu() for (n, _), g in zip(named, grads)}, {}
    state = sharding.gather_state_dict(model)
    shapes = [state[n].shape for n, _ in named]
    grads = sharding.gather_flat(flat[0], named).split([s.numel() for s in shapes])
    return loss.item(), {n: g for (n, _), g in zip(named, grads)}, {}


def tp_sp_w2v(rank, sp, tp, addrs, root, wave_root, dev, fa):
    """One rank's part of wav2vec 2.0's 2-rank phases (z11-z13): the
    pretraining run through train.main on phase a's waves for 1 epoch with
    validation, in a gloo group started here (the port joins it), every K1
    call's shapes and shard recorded; then, in a second group, the fp32
    layout step and the planted fault's, and the bf16 micro-step at phase
    v's point timed with the rank's peak memory."""
    from liteasr_tpu_torch import parallel, train
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.criterions.wav2vec_loss import Wav2Vec2Loss
    from liteasr_tpu_torch.optims.fused_step import FusedAdam, constant_schedule
    from liteasr_tpu_torch.parallel import sharding

    dist = torch.distributed
    calls = []  # (q shape, shard) of every K1 call
    launch_fwd = fa._launch_fwd

    def rec_fwd(q, k, v, mask, kv_lens, rel_qv, rel_p, scale, return_lse, *a):
        calls.append((tuple(q.shape), tuple(k.shape), return_lse, a[-1]))
        return launch_fwd(q, k, v, mask, kv_lens, rel_qv, rel_p, scale, return_lse, *a)

    dist.init_process_group("gloo", init_method=f"tcp://{addrs[0]}", world_size=2, rank=rank)
    run = os.path.join(root, f"tpsp_w2v_sp{sp}_tp{tp}")
    overrides = w2v_overrides(wave_root, run, 1) + [
        f"distributed.coordinator_address={addrs[0]}", "distributed.num_processes=2",
        f"distributed.process_id={rank}", f"distributed.sp={sp}", f"distributed.tp={tp}",
        "common.trigger=[{name: valid, interval: 1, unit: epoch}, "
        "{name: save_model, interval: 1, unit: epoch}]"]
    reset_counts(fa)
    parallel.counts.clear()
    fa._launch_fwd = rec_fwd
    try:
        t0 = time.perf_counter()
        trainer = train.main(overrides, device=dev)  # joins this group, ends it
        torch.cuda.synchronize()
    finally:
        fa._launch_fwd = launch_fwd
    res = dict(train_s=time.perf_counter() - t0, counts=counts(fa),
               collectives=dict(parallel.counts), calls=calls,
               micro=trainer.step, n_valid=len(trainer.valid_set),
               skipped=int(trainer.tx.notfinite_count), updates=int(trainer.tx.count),
               losses=[float(x) for x in trainer._loss_accum],
               backend=trainer.backend, layout=trainer.layout, run=run)
    del trainer

    dist.init_process_group("gloo", init_method=f"tcp://{addrs[1]}", world_size=2, rank=rank)
    parallel.distributed_init(dict(coordinator_address=addrs[1], num_processes=2,
                                   process_id=rank, sp=sp, tp=tp), dev)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["step"] = w2v_layout_step(dev, shard=True)
        fault = W2V_TP_SP_FAULTS["sp" if sp > 1 else "tp"]
        with planted_w2v_fault(fault):
            res["faults"] = {fault: w2v_layout_step(dev, shard=True)}
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(SEED)
        model = sharding.shard_model(build_w2v_model(torch.bfloat16, dev), parallel.layout())
        crit = Wav2Vec2Loss(DotDict(diversity_weight=1.0))
        named = list(model.named_parameters())
        tx = FusedAdam([p for _, p in named], constant_schedule(2e-4), 0.9, 0.999, 1e-8,
                       clip=5.0, sharded=sharding.sharded_parameters(model))
        batch, real = w2v_step_batch(dev)

        def step():
            loss, _ = crit(model, dict(batch, step=0), train=True)
            loss.backward()
            tx.update([p.grad for _, p in named])
            for _, p in named:
                p.grad = None
            return loss

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        parallel.counts.clear()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(3):
                loss = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 3)
        res.update(step_ms=statistics.median(times) * 1e3, step_loss=loss.item(),
                   step_rows=W2V_STEP_ROWS,
                   step_collectives={k: v / 9 for k, v in parallel.counts.items()},
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del step, loss, model, tx
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        parallel.destroy()
    return res


def check_w2v_tp_sp_run(res, sp, tp, label, name):
    """z11 for one layout: every rank's K1 launches (W2V_LAYERS per valid
    batch, no K1' or K2: the training attention is plain), each at the
    rank's heads (tp) or its block of the frames over all of them (sp),
    finite losses, the skipped updates printed; the checkpoint in the
    one-process layout (the same keys and shapes). Returns the K1
    launches of both ranks."""
    from liteasr_tpu_torch.parallel import sharding

    heads, total = W2V_HEADS // tp, 0
    for r, x in enumerate(res):
        fwd, lse, bwd = x["counts"]
        if (lse, bwd) != (0, 0) or fwd != W2V_LAYERS * x["n_valid"] or len(x["calls"]) != fwd:
            raise RuntimeError(f"{label} rank {r}: K1 {fwd} (recorded {len(x['calls'])}), "
                               f"K1' {lse}, K2 {bwd} for {x['n_valid']} valid batches")
        if x["backend"] != "gloo" or not all(math.isfinite(v) for v in x["losses"]):
            raise RuntimeError(f"{label} rank {r}: backend {x['backend']}, losses {x['losses']}")
        lay = x["layout"]
        for q_shape, k_shape, lse_call, shard in x["calls"]:
            sizes = sharding.split_sizes(shard.t_q or q_shape[1], sp)
            want = (not lse_call and shard.h_local == heads and shard.h_total == W2V_HEADS
                    and shard.head0 == lay.tp_i * heads and q_shape[0] == k_shape[0]
                    and q_shape[0] % heads == 0 and q_shape[1] == sizes[lay.sp_i]
                    and shard.q0 == sum(sizes[:lay.sp_i]) and k_shape[1] == sum(sizes))
            if not want:
                raise RuntimeError(f"{label} rank {r}: K1 at q {q_shape}, k {k_shape}, {shard}")
        total += fwd
    run = res[0]["run"]
    ref_shapes = {k: tuple(v.shape) for k, v in
                  build_w2v_model(torch.bfloat16, "cpu").state_dict().items()}
    ckpt = torch.load(os.path.join(run, "ckpts", "model.ep.1.pt"), weights_only=True)
    if {k: tuple(v.shape) for k, v in ckpt.items()} != ref_shapes:
        raise RuntimeError(f"{label}: the checkpoint's layout is not the one-process one")
    valid = w2v_valid_lines(run)
    if not valid or "| code_ppl:" not in valid[-1]:
        raise RuntimeError(f"{label}: valid lines {valid}")
    qs = sorted(set(c[0] for c in res[0]["calls"]))
    log(f"tp/sp train {label} (2 ranks on one card, gloo on CUDA tensors): {res[0]['micro']} "
        f"micro-batches in {res[0]['train_s']:.2f} s incl. the group's start, validation and "
        f"checkpoint; K1 {res[0]['counts'][0]} a rank ({W2V_LAYERS} per valid batch, "
        f"{res[0]['n_valid']} batches) at q {qs}; {res[0]['updates']} updates, "
        f"{res[0]['skipped']} skipped (non-finite); losses rank 0 "
        f"{[round(v, 3) for v in res[0]['losses']]}, rank 1 "
        f"{[round(v, 3) for v in res[1]['losses']]}; collectives {res[0]['collectives']}; "
        f"{valid}; checkpoint in the one-process layout [{name}]")
    return total


def tp_sp_worker(rank, sp, tp, addrs, root, wave_root, out, dev=torch.device("cuda", 0)):
    """One of the 2 ranks of phases z2-z13, on cuda:0, each family of
    TP_SP_FAMILIES in turn (:func:`tp_sp_family`), then wav2vec 2.0
    (:func:`tp_sp_w2v`), in gloo groups that it starts itself (NCCL refuses
    two ranks on one device); ``addrs`` holds two addresses a family.
    Writes the results by family ("w2v" for wav2vec 2.0) to ``out``."""
    from liteasr_tpu_torch.ops import flash_attention as fa

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addrs = addrs.split(",")
    res = {family: tp_sp_family(family, rank, sp, tp, addrs[2 * i:2 * i + 2], root, dev, fa)
           for i, family in enumerate(TP_SP_FAMILIES)}
    res["w2v"] = tp_sp_w2v(rank, sp, tp, addrs[-2:], root, wave_root, dev, fa)
    torch.save(res, out)


def check_tp_sp_run(fa, family, label, res, sp, tp, dev, name):
    """z2/z5/z8 for one family in one layout: every rank's K1' / K2 / K1
    launches (K1' and K2 per micro-batch: the encoder's layers; K1:
    :func:`family_k1`), each K1' / K2 call at the rank's heads and block of
    the T' queries, each micro-batch's K1 calls (the Paraformer's pass 1)
    at the rank's heads of its block of rows, finite losses; the checkpoint
    in the one-process layout, decoded in one process to the error count
    the run's inference trigger logged; the RNN-T DP's launches in the
    run and in the bf16 micro-steps (the transducer's only). Returns the
    (K1, K1', K2) launches and the (forward, backward) DP launches of both
    ranks."""
    from liteasr_tpu_torch import infer
    from liteasr_tpu_torch.config import compose
    from liteasr_tpu_torch.config.core import load_yaml
    from liteasr_tpu_torch.parallel import sharding

    enc = TD_ENC_LAYERS if family == "rnnt" else ENC_LAYERS
    pass1 = 2 * DEC_LAYERS if family == "paraformer" else 0
    micro, heads = res[0]["micro"], HEADS // tp
    total, total_dp = [0, 0, 0], [0, 0]
    for r, x in enumerate(res):
        fwd, lse, bwd = x["counts"]
        if ((lse, bwd) != (enc * micro, enc * micro)
                or fwd - lse != family_k1(family, micro, x["n_valid"])):
            raise RuntimeError(f"{label} rank {r}: K1' {lse}, K2 {bwd}, K1 {fwd - lse} for "
                               f"{micro} micro-batches, {x['n_valid']} valid batches")
        if x["backend"] != "gloo" or not all(math.isfinite(v) for v in x["losses"]):
            raise RuntimeError(f"{label} rank {r}: backend {x['backend']}, losses {x['losses']}")
        lay = x["layout"]
        for kind, q_shape, qv_shape, shard in x["calls"]:
            # the rank's heads of each row, or its block of the T' queries
            sizes = sharding.split_sizes(shard.t_q or q_shape[1], sp)
            want = (shard.h_local == heads and shard.h_total == HEADS
                    and shard.head0 == lay.tp_i * heads and q_shape[0] % shard.h_local == 0
                    and q_shape[1] == sizes[lay.sp_i] and shard.q0 == sum(sizes[:lay.sp_i])
                    and qv_shape[1] == q_shape[1] + (sp > 1))
            if not want:
                raise RuntimeError(f"{label} rank {r}: {kind} at {q_shape}, q_v {qv_shape}, "
                                   f"{shard}")
        if len(x["steps"]) != micro:
            raise RuntimeError(f"{label} rank {r}: {len(x['steps'])} train steps recorded")
        # the transducer's RNN-T DP: one backward launch a micro-batch whose
        # block of rows this rank holds, and one forward more a valid batch
        # (each holds N_VALID >= sp rows); one each way a bf16 micro-step
        held = sum(sharding.split_sizes(rows, sp)[lay.sp_i] > 0 for rows, _ in x["steps"])
        want_dp = (held + x["n_valid"], held) if family == "rnnt" else (0, 0)
        want_step = (17, 17) if family == "rnnt" else (0, 0)
        if x["dp_counts"] != want_dp or x["step_dp_counts"] != want_step:
            raise RuntimeError(f"{label} rank {r}: RNN-T DP launches {x['dp_counts']} in the "
                               f"run (want {want_dp}), {x['step_dp_counts']} in the micro-steps "
                               f"(want {want_step})")
        total_dp = [a + b + c for a, b, c in
                    zip(total_dp, x["dp_counts"], x["step_dp_counts"])]
        for rows, k1 in x["steps"]:
            # pass 1 on the rank's block of rows, at its heads
            mine = sharding.split_sizes(rows, sp)[lay.sp_i]
            offset = (fa.WHOLE if tp == 1 else
                      fa.Shard(head0=lay.tp_i * heads, h_local=heads, h_total=HEADS))
            if len(k1) != pass1 or any(q[0] != mine * heads or s != offset for q, s in k1):
                raise RuntimeError(f"{label} rank {r}: K1 in a micro-batch of {rows} rows: "
                                   f"{k1}")
        total = [a + b for a, b in zip(total, (fwd, lse, bwd))]
    run = res[0]["run"]
    build = {"u2": build_model, "rnnt": build_td_model, "paraformer": build_para_model}[family]
    ref_shapes = {k: tuple(v.shape) for k, v in build(torch.bfloat16, "cpu").state_dict().items()}
    ckpt = torch.load(os.path.join(run, "ckpts", "model.ep.1.pt"), weights_only=True)
    if {k: tuple(v.shape) for k, v in ckpt.items()} != ref_shapes:
        raise RuntimeError(f"{label}: the checkpoint's layout is not the one-process one")
    with open(os.path.join(run, "train.log")) as f:
        text = f.read()
    logged = re.findall(r"test error rate: (\d+) / (\d+)", text)
    cfg = compose(["inference.ckpt_name=1", "inference.model_avg=false",
                   "distributed.coordinator_address=null", "distributed.sp=1",
                   "distributed.tp=1"], base=load_yaml(os.path.join(run, "config.yaml")))
    one = infer.infer(cfg, device=dev)
    if [tuple(int(v) for v in m) for m in logged] != [tuple(one[0])]:
        raise RuntimeError(f"{label}: the run's inference trigger logged {logged}, one "
                           f"process decodes {one}")
    valid = [ln.split(" - ")[-1].strip() for ln in text.splitlines() if "valid loss:" in ln]
    if family == "paraformer" and not all("| loss_ce:" in v and "| loss_mae:" in v
                                          for v in valid):
        raise RuntimeError(f"{label}: valid lines {valid}")
    qs = sorted(set(c[1] for c in res[0]["calls"]))[:2]
    qvs = sorted(set(c[2] for c in res[0]["calls"]))[:2]
    k1s = sorted(set(q for _, k1 in res[0]["steps"] for q, _ in k1))[:2]
    log(f"tp/sp train {label} (2 ranks on one card, gloo on CUDA tensors): {micro} "
        f"micro-batches in {res[0]['train_s']:.2f} s incl. the group's start, validation, "
        f"checkpoint and decode; K1' {res[0]['counts'][1]} + K2 {res[0]['counts'][2]} a rank "
        f"({enc} + {enc} per micro-batch) at q {qs} q_v {qvs}"
        + (f"; pass 1's K1 {pass1} per micro-batch at q {k1s}" if pass1 else "")
        + f"; losses rank 0 {[round(v, 3) for v in res[0]['losses']]}, rank 1 "
        f"{[round(v, 3) for v in res[1]['losses']]}; collectives {res[0]['collectives']}; "
        f"{valid}; checkpoint in the one-process layout, decoded in one process: error "
        f"count {one[0][0]}/{one[0][1]}, as the trigger logged; RNN-T DP launches "
        f"(forward, backward) rank 0 {res[0]['dp_counts']} in the run and "
        f"{res[0]['step_dp_counts']} in the micro-steps [{name}]")
    return total, total_dp


def check_tp_sp_step(family, label, res, sp, ref, floor, resolution, name, tol=TP_SP_TOL):
    """z3/z6/z9/z12 for one family in one layout: the fp32 step against the
    one-process step ``ref`` (the loss within TP_SP_LOSS_TOL, every leaf
    within ``tol`` of its max), beside two one-process runs' difference
    ``floor`` and the step's fp32 resolution; each planted fault must fail
    that bound."""
    def against_one(shares):
        """(loss, its relative error, the leaves' errors, worst first)"""
        got = (sum(s[0] for s in shares) if sp > 1 else shares[0][0], shares[0][1],
               shares[0][2])
        worst = sorted(((e, n) for n, e in leaf_diffs(ref, got).items()), reverse=True)
        return got[0], abs(got[0] - ref[0]) / abs(ref[0]), worst

    loss, loss_err, worst = against_one([x["step"] for x in res])
    log(f"tp/sp step parity fp32 {label} (2 encoder layers at full width, 2 ranks on one "
        f"card): "
        f"loss {loss:.6f} vs {ref[0]:.6f} (rel {loss_err:.3g}); worst of {len(worst)} "
        f"leaves over their max: {', '.join(f'{n} {e:.3g}' for e, n in worst[:3])}; "
        f"two one-process runs differ by up to {max(floor.values()):.3g}, the "
        f"one-process step with its input moved by 1-2 ulps by up to "
        f"{max(resolution.values()):.3g} ({max(resolution, key=resolution.get)}); bound "
        f"{tol:.3g} (loss {TP_SP_LOSS_TOL:.3g}) [{name}]")
    if loss_err > TP_SP_LOSS_TOL or worst[0][0] > tol:
        raise RuntimeError(f"the {label} step disagrees with the one-process step")
    for fault in res[0]["faults"]:
        f_loss, f_err, f_worst = against_one([x["faults"][fault] for x in res])
        caught = f_err > TP_SP_LOSS_TOL or f_worst[0][0] > tol
        log(f"tp/sp step parity fp32 {label} with the planted fault {fault}: loss rel "
            f"{f_err:.3g}; worst leaves over their max: "
            f"{', '.join(f'{n} {e:.3g}' for e, n in f_worst[:3])}; "
            f"{'caught' if caught else 'NOT caught'} by the bound {tol:.3g} [{name}]")
        if not caught:
            raise RuntimeError(f"the bound misses the planted fault {fault} at {label}")


def run_tp_sp(fa, root, wave_root, dev, name):
    """Phases z2-z13 for each family of TP_SP_FAMILIES (U2: z2-z4, the
    transducer: z5-z7, the Paraformer: z8-z10) and wav2vec 2.0 (z11-z13:
    the pretraining run on phase a's waves, :func:`check_w2v_tp_sp_run`;
    :func:`w2v_layout_step` against one process; the bf16 micro-step at
    phase v's point), for tp = 2 and for sp = 2:
    2 processes on the one card (tp_sp_worker), started together, each
    layout in turn. The training phase (z2, z5, z8): the family at full
    width (my_U2, my_transducer, build_para_model's) through train.main on
    phase 6's corpus for 1 epoch, with the valid, save_model and inference
    triggers (:func:`check_tp_sp_run`). The fp32 step (z3, z6, z9): in the
    layout against the one-process step on the card
    (:func:`check_tp_sp_step`). The bf16 micro-step (z4, z7, z10) at
    bench.py's point: ms and peak memory per rank (informational: the two
    ranks share the card). Returns the report."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = {}
    for family in TP_SP_FAMILIES:
        ref, again = dp_step(dev, family=family), dp_step(dev, family=family)
        moved = dp_step(dev, perturb=2.0 ** -23, family=family)
        refs[family] = ref, leaf_diffs(ref, again), leaf_diffs(ref, moved)
    ref, again = w2v_layout_step(dev), w2v_layout_step(dev)
    moved = w2v_layout_step(dev, perturb=2.0 ** -23)
    refs["w2v"] = ref, leaf_diffs(ref, again), leaf_diffs(ref, moved)
    # the step's fp32 resolution sets the bound where it exceeds TP_SP_TOL
    w2v_res = max(refs["w2v"][2].values())
    w2v_tol = TP_SP_TOL if w2v_res <= TP_SP_TOL else 2 * w2v_res
    log(f"wav2vec 2.0's fp32 layout step: resolution {w2v_res:.3g} of a leaf's max, bound "
        f"{w2v_tol:.3g} [{name}]")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    gc.collect()
    torch.cuda.empty_cache()  # the ranks' micro-steps share the card
    rep = {"fwd": 0, "lse": 0, "bwd": 0, "rnnt_dp": [0, 0]}
    for sp, tp in TP_SP_LAYOUTS:
        addrs = ",".join(free_address() for _ in range(2 * len(TP_SP_FAMILIES) + 2))
        outs = [os.path.join(root, f"tpsp_{sp}{tp}_r{r}.pt") for r in (0, 1)]
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-sp-worker",
                                   str(r), str(sp), str(tp), addrs, root, wave_root, outs[r]],
                                  env=env)
                 for r in (0, 1)]
        try:
            codes = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if codes != [0, 0]:
            raise RuntimeError(f"sp={sp} tp={tp}: the ranks exited with {codes}")
        by_rank = [torch.load(o, weights_only=False) for o in outs]
        for family in TP_SP_FAMILIES:
            res = [x[family] for x in by_rank]
            label = f"{FAMILY_NAMES[family]} sp={sp} tp={tp}"
            (fwd, lse, bwd), dp = check_tp_sp_run(fa, family, label, res, sp, tp, dev, name)
            rep["rnnt_dp"] = [a + b for a, b in zip(rep["rnnt_dp"], dp)]
            rep["fwd"] += fwd
            rep["lse"] += lse
            rep["bwd"] += bwd
            rep[f"{family}_launches"] = rep.get(f"{family}_launches", 0) + fwd + bwd
            check_tp_sp_step(family, label, res, sp, *refs[family], name)
            for r, x in enumerate(res):
                log(f"tp/sp micro-step {label} rank {r} at bench.py's point (bf16, B="
                    f"{x['step_rows']}, both ranks on the one card): {x['step_ms']:.2f} ms "
                    f"(informational), loss {x['step_loss']:.4f}, peak {x['peak_gib']:.2f} "
                    f"GiB, collectives per micro-step {x['step_collectives']} [{name}]")
            rep[f"{family}_sp{sp}_tp{tp}_step_ms"] = [x["step_ms"] for x in res]
            rep[f"{family}_sp{sp}_tp{tp}_peak_gib"] = [x["peak_gib"] for x in res]
        res = [x["w2v"] for x in by_rank]
        label = f"wav2vec 2.0 sp={sp} tp={tp}"
        fwd = check_w2v_tp_sp_run(res, sp, tp, label, name)  # z11
        rep["fwd"] += fwd
        rep["w2v_launches"] = rep.get("w2v_launches", 0) + fwd
        rep[f"w2v_sp{sp}_tp{tp}_skipped"] = [x["skipped"] for x in res]
        check_tp_sp_step("w2v", label, res, sp, *refs["w2v"], name, tol=w2v_tol)  # z12
        rep["w2v_tol"], rep["w2v_resolution"] = w2v_tol, w2v_res
        for r, x in enumerate(res):  # z13
            log(f"tp/sp micro-step {label} rank {r} at phase v's point (bf16, B="
                f"{x['step_rows']} with 1 dummy row, both ranks on the one card): "
                f"{x['step_ms']:.2f} ms (informational), loss {x['step_loss']:.4f}, peak "
                f"{x['peak_gib']:.2f} GiB, collectives per micro-step "
                f"{x['step_collectives']} [{name}]")
        rep[f"w2v_sp{sp}_tp{tp}_step_ms"] = [x["step_ms"] for x in res]
        rep[f"w2v_sp{sp}_tp{tp}_peak_gib"] = [x["peak_gib"] for x in res]
    return rep


def load_baseline(root):
    """The flash_attention module of another checkout (the parent commit,
    unpacked with git archive), loaded on its own: it builds that
    checkout's csrc/ into that checkout's build/."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "baseline_flash_attention",
        os.path.join(root, "liteasr_tpu_torch", "ops", "flash_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_kernels(fa, base, dev, name):
    """``--baseline DIR``: each bf16 kernel call of the main paths timed in
    the order baseline, this tree, this tree, baseline, in one process."""
    cases = []
    gen = torch.Generator().manual_seed(SEED)
    for shape, args in slice_shapes(gen, dev, torch.bfloat16).items():
        s = args["q"].shape[-1] ** -0.5
        cases.append((f"K1 {shape}", lambda m, a=args, s=s: m.flash_attention(scale=s, **a)))
    for label, seed, bh, t in (("train", SEED + 1, TRAIN_BH, TRAIN_T),
                               ("long", SEED + 3, LONG_BH, LONG_T)):
        x = train_slice_inputs(torch.Generator().manual_seed(seed), dev, torch.bfloat16,
                               bh, t)
        ins = [x[n] for n in ("q_u", "qv", "k", "v", "p")]
        kv, dout = x["kv_lens"], x["dout"]
        s = TRAIN_D ** -0.5

        def fwd(m, ins=ins, kv=kv, s=s):
            return m.flash_attention(ins[0], ins[2], ins[3], kv_lens=kv, rel_qv=ins[1],
                                     rel_p=ins[4], scale=s, return_lse=True,
                                     dropout_rate=TRAIN_RATE, dropout_seed=TRAIN_SEED)

        out, lse = fwd(fa)
        cases.append((f"K1' {label} BH={bh} T'={t}", fwd))
        cases.append((f"K2 {label} BH={bh} T'={t}",
                      lambda m, ins=ins, kv=kv, o=out.float(), l=lse, d=dout, s=s:
                      m.flash_rel_attention_bwd(*ins, kv, o, l, d, s, TRAIN_RATE,
                                                TRAIN_SEED)))
    for label, f in cases:
        ms = [cuda_time_ms(lambda m=m: f(m)) for m in (base, fa, fa, base)]
        log(f"A/B {label} bf16: baseline {ms[0]:.4f} {ms[3]:.4f} ms, this tree "
            f"{ms[1]:.4f} {ms[2]:.4f} ms [{name}]")


def report_build(path):
    """Prints ptxas's registers / shared memory / spills per kernel (from
    the build log beside the library) and the library's tensor-core and
    asynchronous-copy instructions as cuobjdump -sass lists them."""
    log_path = path.with_suffix(".log")
    if log_path.is_file():
        kernel = "?"
        for ln in log_path.read_text().splitlines():
            m = re.search(r"\d+(rel_attn_\w+?_kernel|bwd_prep_kernel)(I(?:L[a-z]+\d+E|[a-z])+E)?",
                          ln)
            if m:
                kernel = m.group(1) + (m.group(2) or "")
            elif "Used" in ln or "spill" in ln:
                log(f"ptxas {path.name} {kernel}: {ln.split(':', 1)[-1].strip()}")
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    ops = {op: len(re.findall(rf"\s{op}[.\s]", sass))
           for op in ("HGMMA", "HMMA", "LDSM", "LDGSTS", "FFMA")}
    log(f"sass {path.name}: " + ", ".join(f"{k} {v}" for k, v in ops.items()))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.ops import flash_attention as fa
    from liteasr_tpu_torch.tasks.asr import ASRTask

    if sys.argv[1:2] == ["--tp-sp-worker"]:  # one rank of phases z2-z13
        rank, sp, tp, addrs, root, wave_root, out = sys.argv[2:9]
        tp_sp_worker(int(rank), int(sp), int(tp), addrs, root, wave_root, out)
        return 0
    if sys.argv[1:2] == ["--export-worker"]:  # phase e1's process
        export_worker(sys.argv[2])
        return 0
    dev = torch.device("cuda", 0)
    name = card()
    log(name)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    if "--profile-train" in sys.argv[1:]:
        fa.build_libraries()
        profile_train_step(dev, name)
        return 0

    t0 = time.perf_counter()
    libs = fa.build_libraries()
    for lib in libs:
        fa.load_library(lib)
    log(f"kernel build (parallel nvcc): {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in libs.values())})")
    for path in libs.values():
        report_build(path)
    if "--baseline" in sys.argv[1:]:
        base = load_baseline(sys.argv[sys.argv.index("--baseline") + 1])
        base.build_libraries()
        compare_kernels(fa, base, dev, name)
        return 0
    if "--convergence" in sys.argv[1:]:
        keep = sys.argv[sys.argv.index("--keep") + 1] if "--keep" in sys.argv else None
        deadline = (float(sys.argv[sys.argv.index("--deadline") + 1])
                    if "--deadline" in sys.argv else CONVERGENCE_DEADLINE_S)
        run_convergence(fa, dev, name, keep=keep, deadline_s=deadline)
        return 0
    if "--hc-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as root, phase("hc"):
            run_hard_corpus(fa, root, dev, name)
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("2"):
        k1 = check_kernel(fa, dev, name)
    with phase("3"):
        k2 = check_train_kernels(fa, dev, name)
        time_long_kernels(fa, dev, name)
    with phase("k"):
        kc = check_chunk_kernels(fa, dev, name)
    with phase("o"):
        kp = check_para_kernels(fa, dev, name)
    with phase("t"):
        kw = check_w2v_kernels(fa, dev, name)
    with phase("z1"):
        kz = check_shard_kernels(fa, dev, name)
        kzp = check_para_shard_kernels(fa, dev, name)
        kzw = check_w2v_shard_kernels(fa, dev, name)
    if "--kernels-only" in sys.argv[1:]:
        return 0
    if "--export-only" in sys.argv[1:]:  # e1
        with tempfile.TemporaryDirectory() as root, phase("e1"):
            finish_export(*start_export(root))
        return 0
    if "--tp-sp-only" in sys.argv[1:]:  # z2-z13
        with tempfile.TemporaryDirectory() as root:
            write_corpus(root)
            wave_root = write_wave_corpus(root)
            run_tp_sp(fa, root, wave_root, dev, name)
        return 0
    if "--dp-only" in sys.argv[1:]:  # phase 7's step, then x and y
        with tempfile.TemporaryDirectory() as root:
            write_corpus(root)
            plain_step_ms = time_train_step(dev, name)
            run_dp_training(fa, root, dev, name, (ENC_LAYERS, ENC_LAYERS))
            check_dp_parity(dev, name)
            time_dp_step(dev, name, plain_step_ms)
        return 0

    with tempfile.TemporaryDirectory() as root:
        exporting = start_export(root)  # e1's export and load, beside the phases below
        try:
            write_corpus(root)
            task = ASRTask(DotDict(vocab=os.path.join(root, "vocab.txt"),
                                   delimiter=" ", save_dir=os.path.join(root, "ckpt")))
            task.load_dataset("test", os.path.join(root, "test"))
            if task.vocab_size != VOCAB:
                raise RuntimeError(f"vocab size {task.vocab_size} != {VOCAB}")
            with phase("4"):
                decode_fwd, rescore_s = run_slice(fa, task, dev, name)
            with phase("5"):
                check_parity(task, dev, name)
            with phase("6"):
                train_fwd, train_lse, train_bwd, ckpt_fwd = run_training(
                    fa, root, dev, name)
            with phase("7"):
                plain_step_ms = time_train_step(dev, name)
            with phase("8"):
                check_train_parity(dev, name)

            wave_root = write_wave_corpus(root)
            with phase("a"):
                check_frontend(wave_root, dev, name)
            with phase("b"):
                run, (recipe_fwd, recipe_lse, recipe_bwd) = run_recipe(
                    fa, root, wave_root, dev, name)
            with phase("c"):
                avg_fwd = run_averaged_attention(fa, run, dev, name)
            with phase("d"):
                attention_fwd, attention_s = run_slice(fa, task, dev, name, "attention")
            log(f"decode s/batch: attention {attention_s:.4f}, attention_rescore "
                f"{rescore_s:.4f} (phase 4) [{name}]")
            with phase("e"):
                check_beam_parity(task, dev, name)
            with phase("f"):
                check_remat(dev, name)
            with phase("hc"):
                (hc_fwd, hc_lse, hc_bwd), hc_eval_fwd = run_hard_corpus(fa, root, dev, name)

            with phase("g"):
                (td_fwd, td_lse, td_bwd), td_ckpt_fwd, td_dp = run_td_training(
                    fa, root, dev, name)
            with phase("h"):
                td_step = time_td_step(dev, name)
            with phase("i"):
                td_dec_fwd, td_s = run_td_decode(fa, task, dev, name)
            log(f"transducer decode s/batch: greedy {td_s['transducer_greedy']:.4f}, beam "
                f"{td_s['transducer_beam_search']:.4f} (U2 attention_rescore {rescore_s:.4f}) "
                f"[{name}]")
            with phase("j"):
                check_td_parity(task, dev, name)

            with phase("l"):
                dyn, sta, dyn_c, sta_c = run_stream_training(fa, root, dev, name)
                time_stream_step(dev, name)
            with phase("m"):
                stream_dec_fwd, stream_dec_c, stream_pairs, stream_s = run_stream_decode(
                    fa, task, dev, name)
            log("streaming decode s/batch: " + ", ".join(f"{k} {v:.4f}" for k, v in stream_s.items())
                + f" (U2 attention_rescore {rescore_s:.4f}) [{name}]")
            with phase("n"):
                check_stream_parity(task, dev, name, stream_pairs)

            with phase("p"):
                (para_fwd, para_lse, para_bwd), para_ckpt_fwd = run_para_training(
                    fa, root, dev, name)
            with phase("q"):
                para_step = time_para_step(dev, name)
            with phase("r"):
                para_dec_fwd, para_s = run_para_decode(fa, task, dev, name)
            log(f"Paraformer decode s/batch {para_s:.4f} (U2 attention_rescore "
                f"{rescore_s:.4f}); micro-step {para_step['step_ms']:.2f} ms, "
                f"{para_step['utt_s']:.2f} utt/s, peak {para_step['peak_gib']:.2f} GiB [{name}]")
            with phase("s"):
                check_para_parity(task, dev, name)

            with phase("u"):
                w2v_fwd = run_w2v_training(fa, root, wave_root, dev, name)
            with phase("v"):
                w2v_step = time_w2v_step(dev, name)
            log(f"wav2vec2 micro-step {w2v_step['step_ms']:.2f} ms, {w2v_step['utt_s']:.2f} utt/s, "
                f"peak {w2v_step['peak_gib']:.2f} GiB, MFU {w2v_step['mfu']:.2%} (U2 at bench.py's "
                f"point: phase 7) [{name}]")
            with phase("w"):
                check_w2v_parity(dev, name)

            # phase 6 held K1'/K2 to ENC_LAYERS launches each per micro-batch
            with phase("x"):
                dp_fwd, dp_lse, dp_bwd = run_dp_training(
                    fa, root, dev, name, (ENC_LAYERS, ENC_LAYERS))
                check_dp_parity(dev, name)
            with phase("y"):
                dp_step = time_dp_step(dev, name, plain_step_ms)
            with phase("z2-z13"):
                tpsp = run_tp_sp(fa, root, wave_root, dev, name)
            with phase("e1"):  # the card is free: e1's run on it
                ex = finish_export(*exporting)
        finally:
            if exporting[0].poll() is None:
                exporting[0].kill()
                exporting[0].wait()
    # launches with a chunk width, as the wrappers counted them: K1 in the
    # static run's validation and the static model's offline decode (chunk
    # 16), K1'/K2 in the chunked draws and the static run
    chunk_fwd = sta_c[0] + stream_dec_c

    log("phase seconds: " + json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    # rel_attention_fwd: ms / plain_ms are K1's per decoded batch (as since
    # the decode slice); the lse_* keys are K1' (lse + dropout) per call at
    # the training shape and its launches in the training run
    log(json.dumps({"kernels": [{
        "name": "rel_attention_fwd",
        "route": "cuda",
        "source": "liteasr_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "liteasr_tpu/ops/flash_attention.py:177",
        "launches": (decode_fwd + train_fwd + ckpt_fwd + recipe_fwd + recipe_lse
                     + avg_fwd + attention_fwd + td_fwd + td_lse + td_ckpt_fwd
                     + td_dec_fwd + sum(dyn[:2]) + sum(sta[:2]) + stream_dec_fwd
                     + para_fwd + para_lse + para_ckpt_fwd + para_dec_fwd + w2v_fwd
                     + dp_fwd + tpsp["fwd"] + ex["launches"] + hc_fwd + hc_lse
                     + hc_eval_fwd),
        "max_abs_err": max(k1["max_abs_err"], k2["fwd_err"], kc["fwd_err"], kc["k1_err"],
                           kp["max_abs_err"], kw["max_abs_err"], kz["fwd_err"],
                           kzp["max_abs_err"], kzw["max_abs_err"]),
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],  # of the call with the largest bound
        "library_ms": None,  # no single call computes the rel-pos shape
        "decoder_self_mask_ms": k1["decoder_self_mask_ms"],
        "decoder_self_mask_bound_ms": k1["decoder_self_mask_bound_ms"],
        "decoder_self_mask_library_ms": k1["decoder_self_mask_library_ms"],
        "decoder_src_kv_lens_ms": k1["decoder_src_kv_lens_ms"],
        "decoder_src_kv_lens_bound_ms": k1["decoder_src_kv_lens_bound_ms"],
        "decoder_src_kv_lens_library_ms": k1["decoder_src_kv_lens_library_ms"],
        # K1 at the Paraformer decoder's shapes (phase o; bf16, one call
        # each) and its launches on the Paraformer paths (p, r)
        **{f"paraformer_{shape}_{key}": v for shape, r in kp.items() if shape != "max_abs_err"
           for key, v in r.items()},
        # K1 at the wav2vec 2.0 validation shapes (phase t; bf16, one call
        # each) and its launches in the pretraining run (u)
        **{f"wav2vec2_{shape}_{key}": v for shape, r in kw.items() if shape != "max_abs_err"
           for key, v in r.items()},
        "wav2vec2_launches": w2v_fwd,
        "lse_launches": (train_lse + recipe_lse + td_lse + dyn[1] + sta[1] + para_lse
                         + dp_lse + tpsp["lse"] + hc_lse),
        # hc: the hard-corpus recipe's training run (K1 its validation, K1'
        # its micro-batches) and its eval's three decodes
        "hard_corpus_launches": hc_fwd + hc_lse + hc_eval_fwd,
        "hard_corpus_lse_launches": hc_lse,
        # z1: K1' and K1 at the tp and sp shards of the training shape (bf16,
        # one call each); z2: their launches in the 2-rank training runs
        "tp_sp_launches": tpsp["fwd"],
        "tp_sp_lse_launches": tpsp["lse"],
        **{f"shard_{case}_{key}": v for case, r in kz.items() if isinstance(r, dict)
           for key, v in r.items() if key.startswith(("lse_", "k1_"))},
        # z1: K1 at the Paraformer's pass-1 calls under tp = 2 (bf16, one
        # call each; heads 0..2 and 2..4 of 4)
        **{f"paraformer_tp_{case}_{key}": v for case, r in kzp.items()
           if isinstance(r, dict) for key, v in r.items()},
        # z1: K1 at wav2vec 2.0's validation shapes under tp = 2 (heads 0..6
        # and 6..12 of 12) and sp = 2 (the two query blocks), bf16, one call each
        **{f"wav2vec2_shard_{case}_{key}": v for case, r in kzw.items()
           if isinstance(r, dict) for key, v in r.items()},
        # e1: the exported attention_rescore program (24 K1 nodes) on the card
        **{f"export_{key}": v for key, v in ex.items()},
        "tp_sp_launches_by_family": {f: tpsp[f"{f}_launches"] for f in TP_SP_FAMILIES + ("w2v",)},
        "tp_sp_step_ms": {k: v for k, v in tpsp.items() if k.endswith("step_ms")},
        # z12: wav2vec 2.0's fp32 layout step's resolution and its bound;
        # z11: the skipped (non-finite) updates of its training runs
        "tp_sp_w2v_resolution": tpsp["w2v_resolution"],
        "tp_sp_w2v_tol": tpsp["w2v_tol"],
        "tp_sp_w2v_skipped": {k: v for k, v in tpsp.items() if k.endswith("skipped")},
        "tp_sp_peak_gib": {k: v for k, v in tpsp.items() if k.endswith("peak_gib")},
        # phase x: K1 (valid and the decode in the group) and K1' in the
        # one-rank NCCL group; phase y's micro-step in that group
        "dp_launches": dp_fwd,
        "dp_lse_launches": dp_lse,
        "dp_step_ms": dp_step["step_ms"],
        "dp_nogroup_step_ms": dp_step["nogroup_ms"],
        "dp_collectives_host_ms_per_step": dp_step["host_ms"],
        "dp_nccl_kernels_per_step": dp_step["nccl_kernels"],
        "dp_nccl_ms_per_step": dp_step["nccl_ms"],
        # one rank: the call moves no bytes; not the all-reduce's cost on 2+ cards
        "dp_flat_all_reduce_noop_ms": dp_step["noop_ms"],
        "lse_max_abs_err": k2["fwd_err"],
        "lse_ms": k2["fwd_ms"],
        "lse_plain_ms": k2["fwd_plain_ms"],
        "lse_bound_ms": k2["fwd_bound_ms"],
        "lse_bound_by": k2["fwd_bound_by"],
        "lse_library_ms": None,
        # chunked K1 (phase k, encoder decode shape, chunk 16) and K1' by
        # chunk width (0 = none; phase k, training shape)
        "chunk16_launches": chunk_fwd,
        "chunk16_ms": kc["k1_ms"],
        "chunk16_unchunked_ms": kc["k1_full_ms"],
        "chunk16_plain_ms": kc["k1_plain_ms"],
        "chunk16_bound_ms": kc["k1_bound_ms"],
        "chunk16_bound_by": kc["k1_bound_by"],
        "lse_chunk_launches": dyn_c[1] + sta_c[1],
        "lse_chunk_ms": kc["fwd_ms"],
        "lse_chunk_bound_ms": kc["fwd_bound_ms"],
        "lse_chunk16_plain_ms": kc["fwd_plain_ms"],
    }, {
        "name": "rel_attention_bwd",
        "route": "cuda",
        "source": "liteasr_tpu_torch/csrc/rel_attention_bwd.cu",
        "replaces": "liteasr_tpu/ops/flash_attention.py:566",
        "launches": (train_bwd + recipe_bwd + td_bwd + dyn[2] + sta[2] + para_bwd + dp_bwd
                     + tpsp["bwd"] + hc_bwd),
        "hard_corpus_launches": hc_bwd,
        "dp_launches": dp_bwd,
        "tp_sp_launches": tpsp["bwd"],
        **{f"shard_{case}_{key}": v for case, r in kz.items() if isinstance(r, dict)
           for key, v in r.items() if key.startswith("bwd_")},
        "max_abs_err": max(k2["bwd_err"], kc["bwd_err"], kz["bwd_err"]),
        "ms": k2["bwd_ms"],
        "plain_ms": k2["bwd_plain_ms"],
        "bound_ms": k2["bwd_bound_ms"],
        "bound_by": k2["bwd_bound_by"],
        "library_ms": None,  # no single call computes the rel-pos backward
        "chunk_launches": dyn_c[2] + sta_c[2],
        "chunk_ms": kc["bwd_ms"],
        "chunk_bound_ms": kc["bwd_bound_ms"],
        "chunk16_plain_ms": kc["bwd_plain_ms"],
    }, {
        # the RNN-T loss's DP: launches on the main paths g (train.main's
        # micro-batches and valid batches), h (its 23 micro-steps) and z5/z7
        # (both ranks' runs and micro-steps); ms / plain_ms its forward at
        # h's batch, the bwd_* keys its backward, bound_ms either's (the
        # chain of T' + U steps or the two planes' bytes, bound_by);
        # max_abs_err its gradients' against the loop in fp64, limit_share
        # their largest share of the limit (delta of each gradient + 1e-6)
        "name": "rnnt_dp",
        "route": "cuda",
        "source": "liteasr_tpu_torch/csrc/rnnt_dp.cu",
        "replaces": "liteasr_tpu/ops/rnnt.py:77-83",
        "launches": td_dp[0] + td_step["step_launches"][0] + tpsp["rnnt_dp"][0],
        "bwd_launches": td_dp[1] + td_step["step_launches"][1] + tpsp["rnnt_dp"][1],
        "train_launches": list(td_dp),
        "step_launches": list(td_step["step_launches"]),
        "tp_sp_launches": tpsp["rnnt_dp"],
        **{k: v for k, v in td_step.items() if k != "step_launches"},
        "library_ms": None,  # no library computes the transducer's lattice DP
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
