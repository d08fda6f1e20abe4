"""Smoke run of liteasr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the CUDA kernel (csrc/rel_attention_fwd.cu, nvcc, sm_90a);
2. holds the kernel against its plain PyTorch version at the three
   attention shapes of the decode slice, in fp32 (tol 1e-4, TF32 off) and
   bf16 (tol 2e-2), and times both with CUDA events;
3. decodes a generated Kaldi corpus (32 utterances of 1000-1600 frames x 80
   fbank, 5000-token vocab) with the full-width U2 (12 conformer layers,
   256-d, 6 decoder layers, bf16 compute, random weights from a seed)
   through ``infer_dataset`` in attention_rescore mode (beam 10, CTC weight
   0.5, 16 utterances per batch), and checks that every attention went
   through the kernel: 24 launches per batch;
4. runs 2 utterances through the same weights in fp32 on the GPU (kernel)
   and on the CPU (plain path) and bounds the encoder and CTC log-prob
   difference by 1e-3.

Every failure raises, so the exit code is not 0. The last line is the JSON
device record; the line before it lists the kernels.
"""

import json
import os
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


def log(*args):
    print(*args, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` single-call times from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    """Kernel vs plain at the slice shapes. Returns the bf16 numbers the
    kernels line reports."""
    gen = torch.Generator().manual_seed(SEED)
    per_batch = {"encoder_rel": ENC_LAYERS, "decoder_self_mask": DEC_LAYERS,
                 "decoder_src_kv_lens": DEC_LAYERS}
    report = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, args in slice_shapes(gen, dev, dtype).items():
            scale = args["q"].shape[-1] ** -0.5
            out = fa.flash_attention(scale=scale, **args)
            ref = fa.flash_attention_plain(scale=scale, **args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = KERNEL_TOL[dtype]
            bound = tol + tol * ref.float().abs()
            if not bool(((out.float() - ref.float()).abs() <= bound).all()):
                raise RuntimeError(f"K1 {shape} {dtype}: max abs err {err} "
                                   f"exceeds atol=rtol={tol}")
            ms = cuda_time_ms(lambda: fa.flash_attention(scale=scale, **args))
            plain_ms = cuda_time_ms(
                lambda: fa.flash_attention_plain(scale=scale, **args))
            log(f"K1 {shape} {str(dtype)[6:]} shape={tuple(args['q'].shape)}x"
                f"{args['k'].shape[1]}: max_abs_err={err:.3g} (tol {tol}) "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{name}]")
            if dtype == torch.bfloat16:
                report["max_abs_err"] = max(report["max_abs_err"], err)
                report["ms"] += per_batch[shape] * ms
                report["plain_ms"] += per_batch[shape] * plain_ms
    return report


def write_corpus(root: str) -> None:
    from liteasr_tpu_torch.data import kaldi_io

    rng = np.random.default_rng(SEED)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        # <blank> and <sos/eos> complete the file's VOCAB - 2 tokens
        f.write("<unk> 1\n" + "".join(f"w{i} {i + 2}\n" for i in range(VOCAB - 3)))
    d = os.path.join(root, "test")
    os.makedirs(d)
    lens = rng.integers(MIN_T, MAX_T + 1, N_UTT)
    lens[0] = MAX_T
    mats, texts, frames = {}, [], []
    for i, t in enumerate(lens):
        uttid = f"utt{i:03d}"
        mats[uttid] = rng.normal(size=(int(t), FEAT)).astype(np.float32)
        words = rng.integers(0, VOCAB - 3, int(rng.integers(20, 60)))
        texts.append(f"{uttid} " + " ".join(f"w{w}" for w in words))
        frames.append(f"{uttid} {int(t)}")
    kaldi_io.save_ark(os.path.join(d, "feats.ark"), mats,
                      scp_path=os.path.join(d, "feats.scp"))
    with open(os.path.join(d, "utt2num_frames"), "w") as f:
        f.write("\n".join(frames) + "\n")
    with open(os.path.join(d, "text"), "w") as f:
        f.write("\n".join(texts) + "\n")


def build_model(dtype, device):
    from liteasr_tpu_torch.models.u2 import U2

    gen = torch.Generator().manual_seed(SEED)
    return U2(input_dim=FEAT, vocab_size=VOCAB, enc_dim=DIM, enc_ff_dim=2048,
              enc_attn_heads=HEADS, enc_layers=ENC_LAYERS, dec_dim=DIM,
              dec_ff_dim=2048, dec_attn_heads=HEADS, dec_layers=DEC_LAYERS,
              dtype=dtype, device=device, generator=gen).eval()


def run_slice(fa, task, dev, name):
    from liteasr_tpu_torch.infer import infer_dataset

    dataset = task.dataset("test")
    model = build_model(torch.bfloat16, dev)
    cfg = {"batch_size": BATCH, "beam_size": BEAM, "ctc_weight": CTC_WEIGHT,
           "mode": "attention_rescore"}
    n_batches = -(-len(dataset.data) // BATCH)
    audio_s = sum(a.xlen for a in dataset.data) * FRAME_S

    infer_dataset(task, model, dataset, cfg, dev, PAD_TIME, verbose=False)  # warm-up
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    pairs = []
    err, length = infer_dataset(task, model, dataset, cfg, dev, PAD_TIME,
                                verbose=False, collect=pairs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    per_batch = ENC_LAYERS + 2 * DEC_LAYERS
    if launches != per_batch * n_batches:
        raise RuntimeError(f"K1 launched {launches} times for {n_batches} "
                           f"batches, expected {per_batch} per batch")
    if len(pairs) != len(dataset.data) or length <= 0:
        raise RuntimeError("infer_dataset did not score every utterance")
    log(f"slice: {n_batches} batches of <= {BATCH} utts (longest padded to "
        f"1600 frames), {secs / n_batches:.4f} s/batch, "
        f"{len(pairs) / secs:.2f} utt/s, RTF {secs / audio_s:.5f}, "
        f"K1 launches {launches} ({per_batch}/batch), "
        f"error count {err}/{length} (random weights) [{name}]")
    return launches


def check_parity(task, dev, name):
    """2 utterances in fp32: GPU (kernel) vs CPU (plain path)."""
    from liteasr_tpu_torch import decode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from liteasr_tpu_torch.config.core import DotDict
    from liteasr_tpu_torch.ops import flash_attention as fa
    from liteasr_tpu_torch.tasks.asr import ASRTask

    dev = torch.device("cuda", 0)
    name = card()
    log(name)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = fa.build_library()
    fa.load_library()
    log(f"K1 build: {time.perf_counter() - t0:.2f} s ({lib.name})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1 = check_kernel(fa, dev, name)

    with tempfile.TemporaryDirectory() as root:
        write_corpus(root)
        task = ASRTask(DotDict(vocab=os.path.join(root, "vocab.txt"),
                               delimiter=" ", save_dir=os.path.join(root, "ckpt")))
        task.load_dataset("test", os.path.join(root, "test"))
        if task.vocab_size != VOCAB:
            raise RuntimeError(f"vocab size {task.vocab_size} != {VOCAB}")
        launches = run_slice(fa, task, dev, name)
        check_parity(task, dev, name)

    log(json.dumps({"kernels": [{
        "name": "rel_attention_fwd",
        "route": "cuda",
        "source": "liteasr_tpu_torch/csrc/rel_attention_fwd.cu",
        "replaces": "liteasr_tpu/ops/flash_attention.py:177",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
