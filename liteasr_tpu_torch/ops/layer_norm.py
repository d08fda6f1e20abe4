"""LayerNorm over the last dimension, with fp32 statistics (the reference's
Fp32LayerNorm; liteasr_tpu/nets/common.py:32-44, ops/layer_norm.py:29-37).

For x (..., D) in bf16 or fp32, the fp32 weight w and bias b (D,) and the
compute dtype:

    mean = mean(x), var = mean((x - mean)^2)    (fp32, two passes)
    y = (x - mean) rsqrt(var + 1e-12) w + b

rounded to x's dtype, then cast to the compute dtype. :func:`layer_norm_plain`
is that chain in plain PyTorch; autograd differentiates it. It is the path
CPU tensors take, and the kernels' oracle.

A CUDA tensor launches the kernels of ``csrc/layer_norm.cu`` or raises:
one launch forward (the row in registers, y written once) and two
backward (:class:`LayerNormFn`: dx and per-block partial sums of dw and
db, then the partials summed in a fixed order). The backward rounds the
cotangent to x's dtype first, as the plain chain's casts do, and takes
the closed form

    g = dy w,  dx = rstd (g - mean(g) - xhat mean(g xhat))

so no fp32 intermediate of the row reaches device memory, and only x is
kept for the backward. A row of x whose last dimension is not contiguous
(the wav2vec 2.0 extractor's transposed view) is copied to rows once.

Traced (``torch.export``, ``torch.compile``), the function is the custom
op ``liteasr::layer_norm`` (:data:`layer_norm_op`, forward only): its
implementation launches the forward kernel on the card and runs the plain
version elsewhere, so an exported program computes what the live one
does, bit for bit. Registering the op builds nothing; a program exported
with it needs this module imported to load.

``layer_norm.launches`` and ``layer_norm.bwd_launches`` count the kernel
launches; the counters ``layer_norm.kernel_rows`` and
``layer_norm.plain_rows`` (``utils.tracing``, on only under a profiler)
take the rows of each call by the path it took.
"""

import ctypes

import torch

from liteasr_tpu_torch.ops.cuda_libs import Library, check, launch, ptr
from liteasr_tpu_torch.utils import tracing

LN_EPS = 1e-12  # reference liteasr/nets/layer_norm.py:10
MAX_DIM = 1024  # the kernels hold a row in a warp's registers, 32 values a lane
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     compute_dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version: fp32 statistics, the output rounded to x's
    dtype, then cast to ``compute_dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + LN_EPS) * weight + bias
    # the reference rounds to the input's dtype first, then casts
    return y.to(x.dtype).to(compute_dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of x over its last dimension, in ``compute_dtype``.

    A CUDA tensor launches the kernels (x and ``compute_dtype`` bf16 or
    fp32, the last dimension at most :data:`MAX_DIM`; otherwise it raises);
    any other tensor takes :func:`layer_norm_plain`; a traced call is the
    op :data:`layer_norm_op`."""
    if torch.compiler.is_compiling():
        return torch.ops.liteasr.layer_norm(x, weight, bias, compute_dtype)
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    on_card = x.device.type == "cuda"
    tracing.add("layer_norm.kernel_rows" if on_card else "layer_norm.plain_rows", rows)
    if on_card and torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                                or bias.requires_grad):
        return LayerNormFn.apply(x, weight, bias, compute_dtype)
    return _layer_norm_op(x, weight, bias, compute_dtype)


layer_norm.launches = 0
layer_norm.bwd_launches = 0


def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """The forward without autograd, live or traced: the kernel on the
    card, the plain version elsewhere."""
    if x.device.type != "cuda":
        return layer_norm_plain(x, weight, bias, compute_dtype)
    return _launch_fwd(_as_rows(x), weight, bias, compute_dtype).view(x.shape)


# the forward as the op liteasr::layer_norm, for the programs that trace it
layer_norm_op = torch.library.custom_op("liteasr::layer_norm", _layer_norm_op, mutates_args=())


@layer_norm_op.register_fake
def _layer_norm_fake(x, weight, bias, compute_dtype):
    return torch.empty(x.shape, dtype=compute_dtype, device=x.device)


class LayerNormFn(torch.autograd.Function):
    """The kernels under autograd: the forward launch keeps x (as rows)
    and w; the backward's two launches give dx, dw and db."""

    @staticmethod
    def forward(ctx, x, weight, bias, compute_dtype):
        rows = _as_rows(x)
        ctx.save_for_backward(rows, weight)
        ctx.shape = x.shape
        return _launch_fwd(rows, weight, bias, compute_dtype).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        rows, weight = ctx.saved_tensors
        dx, dw, db = _launch_bwd(rows, weight, dy.reshape(rows.shape).contiguous())
        return dx.view(ctx.shape), dw, db, None


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """x as contiguous (rows, D): a view, or one copy where x is strided."""
    D = x.shape[-1] if x.dim() else 0
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"layer_norm: the last dimension is {D}; the kernels take "
                         f"1 to {MAX_DIM}")
    return x.contiguous().view(-1, D)


def _code(op: str, dtype: torch.dtype) -> int:
    if dtype not in _CODES:
        raise TypeError(f"layer_norm: {op} is {dtype}; the kernels take float32 or bfloat16")
    return _CODES[dtype]


def _vec(x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """1 where the kernels may move 16-byte packs: D a multiple of 16 bytes
    of x, every pointer 16-byte aligned."""
    D = x.shape[1]
    return int(D * x.element_size() % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, *tensors)))


# the kernels' C entry points (csrc/layer_norm.cu)
_LIB = Library("layer_norm",
               layer_norm_fwd=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               layer_norm_bwd_blocks=[ctypes.c_int] * 4,
               layer_norm_bwd=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
               layer_norm_bwd_reduce=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p])
_BLOCKS = {}  # (D, x code, y code, vec) -> layer_norm_bwd_blocks


def _launch_fwd(rows, weight, bias, compute_dtype):
    """The forward kernel: y (rows, D) in ``compute_dtype``."""
    codes = _code("x", rows.dtype), _code("the compute dtype", compute_dtype)
    D = rows.shape[1]
    check("layer_norm", rows.device, ("weight", weight, torch.float32, (D,)),
          ("bias", bias, torch.float32, (D,)))
    y = torch.empty(rows.shape, dtype=compute_dtype, device=rows.device)
    if rows.shape[0]:
        launch(_LIB.load().layer_norm_fwd, rows.device, ptr(rows), ptr(weight), ptr(bias),
               ptr(y), *rows.shape, *codes, _vec(rows, weight, bias))
        layer_norm.launches += 1
    return y


def _launch_bwd(rows, weight, dy):
    """The backward kernels: dx (rows, D) in x's dtype, dw and db (D,) fp32,
    for the contiguous cotangent ``dy`` (rows, D) in y's dtype."""
    n, D = rows.shape
    codes = _code("x", rows.dtype), _code("dy", dy.dtype)
    check("layer_norm", rows.device, ("weight", weight, torch.float32, (D,)),
          ("dy", dy, dy.dtype, (n, D)))
    dx = torch.empty_like(rows)
    dw = torch.empty(D, dtype=torch.float32, device=rows.device)
    db = torch.empty_like(dw)
    if not n:
        return dx, dw.zero_(), db.zero_()
    lib = _LIB.load()
    vec = _vec(rows, weight, dy)
    key = (D, *codes, vec)
    if key not in _BLOCKS:
        with torch.cuda.device(rows.device):
            _BLOCKS[key] = lib.layer_norm_bwd_blocks(*key)
        if _BLOCKS[key] < 1:
            raise RuntimeError(f"layer_norm_bwd_blocks{key} failed: {_BLOCKS.pop(key)}")
    blocks = min(_BLOCKS[key], n)
    part = torch.empty((2, blocks, D), dtype=torch.float32, device=rows.device)
    launch(lib.layer_norm_bwd, rows.device, ptr(rows), ptr(weight), ptr(dy), ptr(dx),
           ptr(part), n, D, *codes, vec, blocks)
    launch(lib.layer_norm_bwd_reduce, rows.device, ptr(part), ptr(dw), ptr(db), blocks, D)
    layer_norm.bwd_launches += 2
    return dx, dw, db
