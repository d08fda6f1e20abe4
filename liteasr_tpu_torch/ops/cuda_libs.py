"""The port's CUDA libraries: each ``csrc/<name>.cu``, built with nvcc for
sm_90a through ``utils/shared_lib.py``, loaded with ctypes and launched on
the current stream.

An op module declares its library beside the launcher that calls it, with
the ctypes argument types of each ``extern "C"`` function:
``Library("rnnt_dp", rnnt_dp_fwd=[...], rnnt_dp_bwd=[...])``. Declaring
builds and loads nothing; the first ``load()`` builds, loads and binds the
library, later ones return it, and without a CUDA device it raises (there
is no fallback). Adding a kernel costs one ``csrc/*.cu`` and, in the op
module that uses it, one :class:`Library` and its launcher: no other module
is edited. ``tests/test_torch_cuda_libs.py`` holds every declaration to the
signatures in its source.
"""

import ctypes
import os
import shutil
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

# imported from the module by its full name, which chip_smoke.py's
# --baseline loader stands another checkout's copy in for
from liteasr_tpu_torch.utils.shared_lib import build, library_path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LIBRARIES: Dict[str, "Library"] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


class Library:
    """The CUDA library built from ``csrc/<name>.cu``; ``functions`` maps each
    of its C functions to its ctypes argument types."""

    def __init__(self, name: str, **functions: List[type]) -> None:
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = functions
        LIBRARIES[name] = self

    def path(self) -> Path:
        """The library file of the source and the ``csrc/*.cuh`` headers."""
        headers = [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
        return library_path(self.name, [self.source.read_bytes(), *headers], NVCC_FLAGS)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if missing; raises without CUDA or nvcc."""
        if self.name in _LOADED:
            return _LOADED[self.name]
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA is not available: the {self.name} kernel needs an NVIDIA GPU "
                "(sm_90a) and nvcc")
        lib = ctypes.CDLL(str(build_libraries((self.name,))[self.name]))
        for fn, argtypes in self.functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[self.name] = lib
        return lib


def build_libraries(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named declared libraries (default: all) that are missing, one
    nvcc process each, all at once; each ``.log`` holds ptxas's registers,
    shared memory and spills per kernel. Returns every named library's path."""
    libs = [LIBRARIES[name] for name in (LIBRARIES if names is None else names)]
    paths = {lib.name: lib.path() for lib in libs}
    todo = [lib for lib in libs if not paths[lib.name].is_file()]
    if todo:
        cuda_bin = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin")
        nvcc = shutil.which("nvcc") or shutil.which("nvcc", path=cuda_bin)
        if nvcc is None:
            raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
                               "CUDA kernels of liteasr_tpu_torch cannot be built")
        build({paths[lib.name]: [nvcc, *NVCC_FLAGS, str(lib.source)] for lib in todo})
    return paths


def launch(fn, device: torch.device, *args) -> None:
    """Call C function ``fn`` with ``args`` and ``device``'s current stream."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def check(op: str, device: torch.device, *tensors) -> None:
    """Each ``(name, tensor, dtype, shape)``: that dtype and shape, contiguous, on ``device``."""
    for name, t, dtype, shape in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A ``void*`` argument: ``t``'s device address, NULL for None."""
    return None if t is None else t.data_ptr()
