"""liteasr_tpu_torch's front end against liteasr_tpu's, on the CPU in fp32:
the mel matrix (exact), the log-mel fbank with CMVN (within 2e-4, near-
silent frames included; see ``EMPTY_BIN_BOUND`` for the empty filters),
the raw-wave dummy length, and SpecAugment: the bicubic and linear warps
at given (center, warped) and the whole augmentation at the draws the JAX
op makes (within 1e-5), the ranges of the port's draws, padding left
untouched (but by the frequency masks, which span every row in both
packages), and one result per (seed, step); ``infer_dataset`` on a
raw-wave test set gives the JAX package's hypotheses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liteasr_tpu.config.core import DotDict
from liteasr_tpu.data import dataset as jdataset
from liteasr_tpu.infer import infer_dataset as jax_infer_dataset
from liteasr_tpu.tasks.asr import ASRTask as JaxASRTask
from liteasr_tpu_torch import infer
from liteasr_tpu.ops import fbank as jfbank
from liteasr_tpu.ops import spec_augment as jsa
from liteasr_tpu_torch.data import dataset as tdataset
from liteasr_tpu_torch.ops import fbank as tfbank
from liteasr_tpu_torch.ops import spec_augment as tsa
from liteasr_tpu_torch.tasks.asr import ASRTask

from test_torch_u2 import build_pair

FBANK_TOL = 2e-4  # after CMVN, in units of the per-utterance std
# an empty mel filter (bins 1 and 8 of the 80-bin matrix) gives a constant
# log floor; the reference's fp32 CMVN turns the rounding of its mean into
# noise of up to ~1e-6 x rsqrt(1e-8), the port's fp64 statistics into 0
EMPTY_BIN_BOUND = 0.05
SA_TOL = 1e-5


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    """wav.scp corpus: 9 train, 3 valid and 5 test utterances of 0.25-0.5 s."""
    from liteasr_tpu_torch.data import kaldi_io

    root = tmp_path_factory.mktemp("wav_corpus")
    rng = np.random.default_rng(5)
    tokens = ["<unk>"] + [chr(ord("a") + i) for i in range(26)]
    (root / "vocab.txt").write_text("".join(f"{tok} {i + 1}\n" for i, tok in enumerate(tokens)))
    for split, n in (("train", 9), ("valid", 3), ("test", 5)):
        d = root / split
        d.mkdir()
        scp, text = [], []
        for i in range(n):
            u = f"{split}{i}"
            p = str(d / f"{u}.wav")
            length = int(rng.integers(4000, 8000))
            kaldi_io.write_wav(p, (rng.normal(size=length) * 0.05).astype(np.float32))
            scp.append(f"{u} {p}")
            text.append(f"{u} " + "".join(chr(ord("a") + int(c))
                                          for c in rng.integers(0, 26, 4)))
        (d / "wav.scp").write_text("\n".join(scp) + "\n")
        (d / "text").write_text("\n".join(text) + "\n")
    return root


def _waves(seed, B=3, S=8000):
    """Noise at three loudness levels, a sine, and a near-silent stretch
    (the frames where the log floor and CMVN amplify rounding)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S)).astype(np.float32) * np.array([0.3, 0.01, 1e-4],
                                                             np.float32)[:B, None]
    x[0] += 0.5 * np.sin(np.arange(S) * 0.07).astype(np.float32)
    x[1, 2000:3000] *= 1e-4
    lens = np.array([S, S - 1234, 3001][:B], np.int32)
    for b in range(B):
        x[b, lens[b]:] = 0.0
    return x, lens


@pytest.mark.parametrize("bins,n_fft,sr", [(80, 512, 16000), (40, 512, 16000),
                                          (23, 256, 8000)])
def test_mel_filterbank_is_the_jax_matrix(bins, n_fft, sr):
    np.testing.assert_array_equal(tfbank.mel_filterbank(bins, n_fft, sr),
                                  jfbank.mel_filterbank(bins, n_fft, sr))


@pytest.mark.parametrize("seed,bins", [(0, 80), (1, 40)])
def test_log_mel_fbank_matches_jax(seed, bins):
    x, lens = _waves(seed)
    jf, jl = jfbank.log_mel_fbank(jnp.asarray(x), jnp.asarray(lens), num_mel_bins=bins)
    tf, tl = tfbank.log_mel_fbank(torch.from_numpy(x), torch.from_numpy(lens),
                                  num_mel_bins=bins)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tf.shape == jf.shape == (3, tfbank.num_frames(x.shape[1]), bins)
    empty = tfbank.mel_filterbank(bins, 512, 16000).sum(0) == 0
    assert empty.sum() == (2 if bins == 80 else 0)
    np.testing.assert_allclose(tf.numpy()[..., ~empty], np.asarray(jf)[..., ~empty],
                               rtol=FBANK_TOL, atol=FBANK_TOL)
    assert (tf.numpy()[..., empty] == 0).all()
    assert np.abs(np.asarray(jf)[..., empty]).max(initial=0) <= EMPTY_BIN_BOUND
    assert tfbank.num_frames(399) == jfbank.num_frames(399) == 0
    assert tfbank.num_frames(16000) == jfbank.num_frames(16000)


def test_dummy_min_xlen_matches_jax():
    for raw in (False, True):
        assert tdataset.dummy_min_xlen(raw) == jdataset.dummy_min_xlen(raw)
    n = tdataset.dummy_min_xlen(True)
    assert tfbank.num_frames(n) == tdataset.MIN_SUBSAMPLE_FRAMES


def _feats(seed, B=4, T=60, D=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32) + 0.5
    xlens = np.array([T, 47, 23, 9][:B], np.int32)
    for b in range(B):
        x[b, xlens[b]:] = 7.0  # padding the warps and masks must not touch
    return x, xlens


@pytest.mark.parametrize("mode", ["bicubic", "linear"])
def test_warps_match_jax(mode):
    x, xlens = _feats(1)
    jwarp = {"bicubic": jsa._warp_bicubic, "linear": jsa._warp_linear}[mode]
    twarp = {"bicubic": tsa.warp_bicubic, "linear": tsa.warp_linear}[mode]
    # (center, warped): stretch, shrink, a shrink past the 2.75x cap, identity
    cases = [(20, 26), (30, 17), (40, 4), (11, 11)]
    for center, warped in cases:
        c = np.minimum(center, xlens - 2)
        w = np.clip(np.minimum(warped, xlens - 1), 1, None)
        ref = np.stack([np.asarray(jwarp(jnp.asarray(x[b]), *map(jnp.int32, (
            xlens[b], c[b], w[b])))) for b in range(len(x))])
        got = twarp(torch.from_numpy(x), torch.from_numpy(xlens), torch.from_numpy(c),
                    torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, ref, rtol=SA_TOL, atol=SA_TOL)
        for b in range(len(x)):
            assert (got[b, xlens[b]:] == 7.0).all()


def _jax_draws(key, xlens, D, W, F, nf, Tm, nt):
    """The draws ``liteasr_tpu.ops.spec_augment.spec_augment`` makes from
    ``key``, re-derived with its own key splits."""
    B = len(xlens)
    keys = jax.random.split(key, B * 3).reshape((B, 3) + jax.random.split(key, 1).shape[1:])
    out = {k: [] for k in ("center", "warped", "freq_start", "freq_width",
                           "time_start", "time_width")}
    for b in range(B):
        xlen = int(xlens[b])
        r1, r2 = jax.random.split(keys[b, 0])
        center = int(jax.random.randint(r1, (), W, max(xlen - W, W + 1)))
        warped = int(jax.random.randint(r2, (), center - W, center + W)) + 1
        out["center"].append(center)
        out["warped"].append(int(np.clip(warped, 1, xlen - 1)))
        for name, param, times, size, k in (("freq", F, nf, D, keys[b, 1]),
                                            ("time", Tm, nt, xlen, keys[b, 2])):
            starts, widths = [], []
            for kk in jax.random.split(k, times):
                k1, k2, k3 = jax.random.split(kk, 3)
                bound = int(jax.random.randint(k1, (), 0, max(param, 1)))
                widths.append(int(jax.random.randint(k2, (), 0, max(param, 1))))
                starts.append(int(np.floor(float(jax.random.uniform(k3))
                                           * max(size - bound, 1))))
            out[f"{name}_start"].append(starts)
            out[f"{name}_width"].append(widths)
    return {k: torch.tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("mode,zero", [("bicubic", False), ("linear", True)])
def test_augmentation_at_the_jax_draws_matches_jax(mode, zero):
    x, xlens = _feats(2)
    kw = dict(time_warp=5, freq_mask=4, freq_mask_times=2, time_mask=10,
              time_mask_times=2)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsa.spec_augment(key, jnp.asarray(x), jnp.asarray(xlens),
                                      replace_with_zero=zero, time_warp_mode=mode, **kw))
    draws = _jax_draws(key, xlens, x.shape[2], 5, 4, 2, 10, 2)
    got = tsa.apply(torch.from_numpy(x), torch.from_numpy(xlens), draws, 5, mode,
                    zero).numpy()
    np.testing.assert_allclose(got, ref, rtol=SA_TOL, atol=SA_TOL)
    assert not np.allclose(got, x)  # something was augmented


def test_draws_lie_in_their_ranges_and_padding_is_untouched():
    x, _ = _feats(4, B=4, T=200, D=40)
    xlens = np.array([200, 150, 17, 9], np.int32)
    for b in range(4):
        x[b, xlens[b]:] = 7.0
    xt, lt = torch.from_numpy(x), torch.from_numpy(xlens)
    W, F, Tm = 5, 8, 12
    for step in range(30):
        gen = tsa.step_generator(11, step, "cpu")
        d = tsa.draw(lt, 40, gen, W, F, 3, Tm, 2)
        xl = lt.long()
        assert ((d["center"] >= W) & (d["center"] < torch.clamp(xl - W, min=W + 1))).all()
        assert ((d["warped"] >= 1) & (d["warped"] <= xl - 1)).all()
        assert ((d["warped"] >= d["center"] - W + 1) | (d["warped"] == 1)).all()
        assert ((d["warped"] <= d["center"] + W) | (d["warped"] == xl - 1)).all()
        assert ((d["freq_width"] >= 0) & (d["freq_width"] < F)).all()
        assert ((d["freq_start"] >= 0) & (d["freq_start"] < 40)).all()
        assert ((d["time_width"] >= 0) & (d["time_width"] < Tm)).all()
        assert ((d["time_start"] >= 0) & (d["time_start"] < xl[:, None])).all()
        out = tsa.apply(xt, lt, d, W).numpy()
        for b in range(4):
            band = np.zeros(40, bool)
            for start, width in zip(d["freq_start"][b].tolist(), d["freq_width"][b].tolist()):
                band[start:start + width] = True
            assert (out[b, xlens[b]:][:, ~band] == 7.0).all()
        # utterances too short to warp (xlen - W <= W) are only masked
        short = tsa.apply(xt, lt, dict(d, freq_width=0 * d["freq_width"],
                                       time_width=0 * d["time_width"]), W).numpy()
        np.testing.assert_array_equal(short[3], x[3])


def test_one_result_per_seed_and_step():
    x, xlens = _feats(5)
    xt, lt = torch.from_numpy(x), torch.from_numpy(xlens)

    def run(seed, step):
        return tsa.spec_augment(xt, lt, tsa.step_generator(seed, step, "cpu"),
                                time_warp=5, freq_mask=4, time_mask=10)

    a = run(1, 7)
    assert torch.equal(a, run(1, 7))
    assert not torch.equal(a, run(1, 8)) and not torch.equal(a, run(2, 7))


def test_raw_wave_infer_dataset_matches_jax(wav_corpus, tmp_path):
    """dataset.fbank: both packages pad the waves, compute the log-mel
    features on their device and decode the same hypotheses."""
    cfg = dict(name="asr", vocab=str(wav_corpus / "vocab.txt"),
               test=[str(wav_corpus / "test")], delimiter=None, save_dir=str(tmp_path))
    dcfg = DotDict(fbank=True, num_mel_bins=16)
    jtask, ttask = JaxASRTask(DotDict(cfg)), ASRTask(DotDict(cfg))
    jtask.load_dataset("test", str(wav_corpus / "test"), dcfg)
    ttask.load_dataset("test", str(wav_corpus / "test"), dcfg)
    assert ttask.dataset("test").fbank and ttask.feat_dim == 16
    jmodel, variables, tmodel = build_pair(11, vocab_size=jtask.vocab_size, input_dim=16)
    infer_cfg = DotDict(batch_size=2, beam_size=3, ctc_weight=0.5,
                        mode="attention_rescore")
    j_pairs, t_pairs = [], []
    j_res = jax_infer_dataset(jtask, jmodel, variables, jtask.dataset("test"), infer_cfg,
                              pad_time_multiple=1600, verbose=False, collect=j_pairs)
    t_res = infer.infer_dataset(ttask, tmodel, ttask.dataset("test"), infer_cfg,
                                torch.device("cpu"), pad_time_multiple=1600,
                                verbose=False, collect=t_pairs)
    assert t_pairs == j_pairs and t_res == j_res
