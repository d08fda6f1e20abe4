"""Weights from the seed, drawn on the device in one call: the benchmark's
input, handed alike to the program and to the plain reference.

A layout is a list of (name, shape, kind): ``normal`` leaves are
N(0, 1/fan_in) with fan_in the numel of one output row (the port's
lecun-normal scale, untruncated), ``normal1`` N(0, 1), ``uniform``
U[0, 1), ``ones`` and ``zeros`` constant.
"""

from typing import Dict, List, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...], str]]


def draw(layout: Layout, seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 leaves of ``layout`` from ``seed``: one ``randn`` on the device
    for every normal leaf together and one ``rand`` for the uniform ones,
    cut and scaled."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def total(kinds):
        return sum(int(torch.Size(s).numel()) for _, s, k in layout if k in kinds)

    flat = torch.randn(total(("normal", "normal1")), generator=gen, device=device)
    flat_u = torch.rand(total(("uniform",)), generator=gen, device=device)
    out, at, at_u = {}, 0, 0
    for name, shape, kind in layout:
        n = int(torch.Size(shape).numel())
        if kind in ("normal", "normal1"):
            scale = (n // shape[0]) ** -0.5 if kind == "normal" else 1.0
            out[name] = flat[at:at + n].view(shape) * scale
            at += n
        elif kind == "uniform":
            out[name] = flat_u[at_u:at_u + n].view(shape).clone()
            at_u += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown init {kind!r}")
    return out
