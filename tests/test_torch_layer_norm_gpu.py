"""LayerNorm's kernels (``csrc/layer_norm.cu``) on the card, without JAX
(``python -m pytest --noconftest -m gpu tests/test_torch_layer_norm_gpu.py``).

On the card (marker ``gpu``, skipped without CUDA) the kernels are held to
the plain version (``layer_norm_plain``, run on the card under autograd) at
D in {256, 512, 768}, x bf16 or fp32 times the compute dtype bf16 or fp32,
and 1, 7 and 51,200 rows; from 7 rows up, two rows are constant (0 and
1.25: zero variance, rstd 1e6, as dp's weight-0 dummy rows meet). The
output, where it is on bf16's grid (x or the compute dtype bf16), lies
within two bf16 ulps of the plain version's at the row's largest output
(the statistics' rounding moves a whole row by an amount of the row's
scale). y, dx, dw and db are held to an fp64 oracle of the same inputs
(x as it is, dy rounded to x's dtype): each kernel output's distance to it
(y's and dx's worst row, each row against its own largest value; dw's and
db's against their largest) is at most twice the plain version's own
distance, plus 2^-24. An fp32 output is held by that rule alone: the plain
fp32 chain itself lies up to 3.7 fp32 ulps (at the row's largest output)
from fp64 at 51,200 rows, and two orders of its sums up to 6 apart, so
two ulps between them is no bound. Two backward calls give the same
bits; the forward is one launch and the backward two, and neither waits
for the host (``torch.cuda.set_sync_debug_mode("error")``). The wav2vec 2.0
extractor's transposed view (B, frames, C) of a (B, C, frames) tensor
gives what its contiguous copy gives; a call under ``no_grad`` launches
the forward alone; a half-precision x and a last dimension above 1,024
are refused; the counter ``layer_norm.kernel_rows`` takes the rows.

A program traced by ``torch.export`` holds one ``liteasr::layer_norm``
node a call and gives the live output bit for bit, on the CPU (the plain
version) and, loaded onto the card, by launching the forward kernel once
a node.

On the CPU (no card needed): a CPU tensor takes the plain version bit for
bit, launches nothing and counts ``layer_norm.plain_rows``; the
launcher's checks refuse what the kernels cannot run.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from liteasr_tpu_torch.nets.common import LayerNorm
from liteasr_tpu_torch.ops import layer_norm as ln
from liteasr_tpu_torch.utils import tracing

DIMS = (256, 512, 768)
ROWS = (1, 7, 51200)
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
PAIRS = [(x, y) for x in DTYPES for y in DTYPES]  # (x's dtype, the compute dtype)
CONSTANT_ROWS = {2: 0.0, 5: 1.25}  # zero-variance rows; any order of summing is exact


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(rows, D, x_dtype, y_dtype, device, seed=0):
    """x (rows, D) at a scale and offset a row, with the constant rows from 7
    rows up; w, b (D,) fp32; dy (rows, D) in the compute dtype."""
    gen = torch.Generator().manual_seed(seed * 1000 + rows + D)
    scale = torch.empty(rows, 1).uniform_(0.5, 4.0, generator=gen)
    x = torch.randn(rows, D, generator=gen) * scale + 0.3
    if rows >= 7:
        for r, v in CONSTANT_ROWS.items():
            x[r] = v
    w = 1.0 + 0.1 * torch.randn(D, generator=gen)
    b = 0.1 * torch.randn(D, generator=gen)
    dy = torch.randn(rows, D, generator=gen)
    return (x.to(device, x_dtype), w.to(device), b.to(device), dy.to(device, y_dtype))


def _run(fn, x, w, b, dy, y_dtype):
    """fn's output and the gradients (dx, dw, db) of sum(y dy)."""
    x, w, b = (t.detach().clone().requires_grad_() for t in (x, w, b))
    y = fn(x, w, b, y_dtype)
    y.backward(dy)
    return y.detach(), x.grad, w.grad, b.grad


def _oracle(x, w, dy):
    """fp64 (dx, dw, db) of the closed form, dy rounded to x's dtype."""
    x64, w64 = x.double(), w.double()
    d = dy.to(x.dtype).double()
    mean = x64.mean(-1, keepdim=True)
    xc = x64 - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + ln.LN_EPS)
    xhat = xc * rstd
    g = d * w64
    dx = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    return dx, (d * xhat).sum(0), d.sum(0)


def _ulp(dtype, t):
    """The spacing of ``dtype``'s numbers at |t|."""
    mantissa = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(1e-30))) - mantissa)


def _row_distance(got, ref):
    """The worst row's largest error against that row's largest value."""
    got, ref = got.double().reshape(-1, ref.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-300)).max().item()


def _distance(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


def _check_forward(y_k, y_p, x, w, b):
    """y against the plain version's: within two bf16 ulps where the output
    is on bf16's grid; and against fp64, as each gradient is."""
    if torch.bfloat16 in (x.dtype, y_k.dtype):
        row_max = y_p.float().abs().amax(-1, keepdim=True)
        gap = (y_k.float() - y_p.float()).abs()
        limit = 2 * _ulp(torch.bfloat16, row_max)
        assert (gap <= limit).all(), f"forward off by {(gap / limit).max().item():.3g} of 2 ulps"
    x64 = x.double()
    xc = x64 - x64.mean(-1, keepdim=True)
    ref = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + ln.LN_EPS) * w.double() + b.double()
    d_k, d_p = _row_distance(y_k, ref), _row_distance(y_p, ref)
    assert d_k <= 2 * d_p + 2.0 ** -24, f"y: kernels {d_k:.3g}, plain {d_p:.3g}"


def _check_gradients(kern, plain, ref):
    for name, k, p, r, dist in (("dx", kern[1], plain[1], ref[0], _row_distance),
                                ("dw", kern[2], plain[2], ref[1], _distance),
                                ("db", kern[3], plain[3], ref[2], _distance)):
        d_k, d_p = dist(k, r), dist(p, r)
        assert d_k <= 2 * d_p + 2.0 ** -24, f"{name}: kernels {d_k:.3g}, plain {d_p:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("x_name,y_name", PAIRS)
def test_kernels_against_the_plain_version_and_fp64(cuda, rows, D, x_name, y_name):
    x_dtype, y_dtype = DTYPES[x_name], DTYPES[y_name]
    x, w, b, dy = _inputs(rows, D, x_dtype, y_dtype, cuda)
    ln.layer_norm.launches = ln.layer_norm.bwd_launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kern = _run(ln.layer_norm, x, w, b, dy, y_dtype)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ln.layer_norm.launches, ln.layer_norm.bwd_launches) == (1, 2)
    plain = _run(ln.layer_norm_plain, x, w, b, dy, y_dtype)
    assert kern[0].dtype == y_dtype and kern[1].dtype == x_dtype
    assert kern[2].dtype == kern[3].dtype == torch.float32
    _check_forward(kern[0], plain[0], x, w, b)
    _check_gradients(kern, plain, _oracle(x, w, dy))
    if rows >= 7:  # the constant rows: y = b as the output dtype rounds it
        for r in CONSTANT_ROWS:
            assert torch.equal(kern[0][r], plain[0][r])
    again = _run(ln.layer_norm, x, w, b, dy, y_dtype)
    for a, k in zip(again, kern):
        assert torch.equal(a, k)


@pytest.mark.gpu
@pytest.mark.parametrize("x_name", DTYPES)
def test_the_extractors_transposed_view(cuda, x_name):
    """(B, frames, C) read from a (B, C, frames) tensor, as wav2vec 2.0's
    extractor hands it over, against its contiguous copy."""
    x_dtype = DTYPES[x_name]
    gen = torch.Generator().manual_seed(7)
    base = torch.randn(3, 512, 1001, generator=gen).to(cuda, x_dtype)
    view = base.transpose(1, 2)
    assert not view.is_contiguous()
    w = (1.0 + 0.1 * torch.randn(512, generator=gen)).to(cuda)
    b = (0.1 * torch.randn(512, generator=gen)).to(cuda)
    dy = torch.randn(3, 1001, 512, generator=gen).to(cuda, x_dtype)
    got = _run(ln.layer_norm, view, w, b, dy, x_dtype)
    want = _run(ln.layer_norm, view.contiguous(), w, b, dy, x_dtype)
    assert got[1].shape == view.shape
    for g, k in zip(got, want):
        assert torch.equal(g, k)
    plain = _run(ln.layer_norm_plain, view, w, b, dy, x_dtype)
    _check_forward(got[0], plain[0], view, w, b)
    _check_gradients(got, plain, _oracle(view, w, dy))


@pytest.mark.gpu
def test_no_grad_launches_the_forward_alone_and_counts_rows(cuda):
    norm = LayerNorm(256, dtype=torch.bfloat16, device=cuda)
    x = torch.randn(4, 50, 256, device=cuda, dtype=torch.bfloat16)
    ln.layer_norm.launches = ln.layer_norm.bwd_launches = 0
    tracing.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        y = norm(x)
    assert (ln.layer_norm.launches, ln.layer_norm.bwd_launches) == (1, 0)
    assert y.grad_fn is None and y.dtype == torch.bfloat16
    totals = tracing.totals()
    assert totals["layer_norm.kernel_rows"] == {"count": 1, "total": 200}
    assert "layer_norm.plain_rows" not in totals
    assert torch.equal(y, ln.layer_norm(x, norm.weight, norm.bias, torch.bfloat16))


@pytest.mark.gpu
def test_the_kernels_refuse_what_they_cannot_run(cuda):
    w, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln.layer_norm(torch.randn(2, 8, device=cuda, dtype=torch.float16), w, b, torch.float16)
    wide = torch.ones(1025, device=cuda)
    with pytest.raises(ValueError, match="1 to 1024"):
        ln.layer_norm(torch.randn(2, 1025, device=cuda), wide, wide, torch.float32)


def test_cpu_tensors_take_the_plain_version():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 24, generator=gen)
    for x_dtype in DTYPES.values():
        for y_dtype in DTYPES.values():
            norm = LayerNorm(24, dtype=y_dtype)
            with torch.no_grad():
                norm.weight.normal_(generator=gen)
                norm.bias.normal_(generator=gen)
            xd = x.to(x_dtype).requires_grad_()
            ln.layer_norm.launches = ln.layer_norm.bwd_launches = 0
            tracing.reset()
            with profile(activities=[ProfilerActivity.CPU]):
                y = norm(xd)
                y.float().sum().backward()
            totals = tracing.totals()
            assert totals["layer_norm.plain_rows"] == {"count": 1, "total": 18}
            assert "layer_norm.kernel_rows" not in totals
            assert (ln.layer_norm.launches, ln.layer_norm.bwd_launches) == (0, 0)
            assert torch.equal(y, ln.layer_norm_plain(xd, norm.weight, norm.bias, y_dtype))


def test_the_launchers_checks_on_the_cpu():
    view = torch.randn(2, 16, 5).transpose(1, 2)
    rows = ln._as_rows(view)
    assert rows.is_contiguous() and torch.equal(rows, view.reshape(-1, 16))
    plain = torch.randn(3, 4, 16)
    assert ln._as_rows(plain).data_ptr() == plain.data_ptr()  # a view, no copy
    for D in (0, 1025):
        with pytest.raises(ValueError, match="1 to 1024"):
            ln._as_rows(torch.zeros(2, D))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln._code("x", torch.float16)
    assert ln._vec(torch.zeros(4, 8, dtype=torch.bfloat16)) == 1
    assert ln._vec(torch.zeros(4, 12, dtype=torch.bfloat16)) == 0  # 24 bytes a row
    assert ln._vec(torch.zeros(4, 8)[:, 1:].contiguous()) == 0  # 28 bytes a row
    assert ln._vec(torch.zeros(40)[1:33].view(4, 8)) == 0  # 4 bytes off 16


class _TwoNorms(torch.nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.a = LayerNorm(64, dtype=torch.bfloat16, device=device)
        self.b = LayerNorm(64, dtype=torch.float32, device=device)
        with torch.no_grad():
            for p in self.parameters():
                p.normal_(generator=torch.Generator(device=p.device).manual_seed(p.numel()))

    def forward(self, x):
        return self.b(self.a(x) * 2.0)


def _exported(model, x):
    ep = torch.export.export(model, (x,), strict=False)
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("liteasr.layer_norm")]
    return ep.module(), len(nodes)


def test_a_traced_program_holds_the_op():
    model = _TwoNorms()
    x = torch.randn(3, 5, 64)
    program, nodes = _exported(model, x)
    assert nodes == 2
    with torch.no_grad():
        assert torch.equal(program(x), model(x))


@pytest.mark.gpu
def test_a_traced_program_launches_the_kernel(cuda):
    model = _TwoNorms(cuda)
    x = torch.randn(3, 5, 64, device=cuda)
    program, nodes = _exported(model, x)
    ln.layer_norm.launches = 0
    with torch.no_grad():
        got = program(x)
    assert nodes == 2 and ln.layer_norm.launches == 2
    with torch.no_grad():
        assert torch.equal(got, model(x))
