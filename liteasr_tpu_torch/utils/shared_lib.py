"""Shared libraries built once into ``build/liteasr_tpu_torch/``, for the
CUDA kernels (``ops/cuda_libs.py``, nvcc) and the host loops (``native``,
g++). A file's name hashes its source, headers and flags, so it is never
stale; each compiler writes a temporary file beside it that an atomic
rename puts in place, so processes building at once never load half a
library; the compiler's output goes to a ``.log`` beside it.
"""

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

# build output lives beside the package, in the repository's build/ tree
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "liteasr_tpu_torch"


class BuildError(RuntimeError):
    """A compiler failed; the message holds the end of its log."""


def library_path(stem: str, inputs: Iterable[bytes], flags: Sequence[str]) -> Path:
    """``BUILD_DIR/lib<stem>.<hash>.so``, the hash over ``inputs`` and ``flags``."""
    digest = hashlib.sha256(b"".join(inputs) + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}.{digest}.so"


def build(commands: Dict[Path, List[str]], timeout: Optional[float] = None) -> None:
    """Run every ``commands[path] + ["-o", <temporary file>]`` at once and
    rename each output to its ``path``; raises :class:`BuildError` (or
    ``TimeoutExpired``) and leaves no temporary file if one fails."""
    tmps, procs = [], []
    try:
        for path, argv in commands.items():
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
            os.close(fd)
            tmps.append(tmp)
            with open(path.with_suffix(".log"), "w") as log:
                procs.append(subprocess.Popen([*argv, "-o", tmp], stdout=log,
                                              stderr=subprocess.STDOUT))
        failed = [path for path, proc in zip(commands, procs) if proc.wait(timeout) != 0]
        if failed:
            logs = "\n".join(p.with_suffix(".log").read_text()[-4000:] for p in failed)
            compiler = os.path.basename(commands[failed[0]][0])
            raise BuildError(f"{compiler} failed to build {[p.name for p in failed]}:\n{logs}")
        for path, tmp in zip(commands, tmps):
            os.replace(tmp, path)  # atomic: no half-written library
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps:
            if os.path.exists(tmp):
                os.remove(tmp)
