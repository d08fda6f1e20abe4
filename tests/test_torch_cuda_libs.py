"""The port's compiled-library runtime on the CPU: every CUDA library that an
op module declares (``ops/cuda_libs.py``) against its source, and the
shared builder (``utils/shared_lib.py``) with g++.

ctypes passes each argument as its declared argtypes say, so a declaration
off by one argument from its ``extern "C"`` function corrupts the kernel's
arguments on the card with no error. Each case parses the C parameter list
of every declared function from its ``csrc/*.cu`` and holds the declaration
to it, type by type; and every ``.cu`` under ``csrc/`` is declared once.
"""

import ctypes
import re

import pytest

# importing an op module declares its library
from liteasr_tpu_torch.ops import cuda_libs, flash_attention, layer_norm, rnnt  # noqa: F401
from liteasr_tpu_torch.utils import shared_lib

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "uint32_t": ctypes.c_uint32}


def c_signatures(source: str):
    """``{function: [ctypes type of each parameter]}`` of the source's
    ``extern "C" int`` functions."""
    sigs = {}
    for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
        types = []
        for param in params.split(","):
            ctype = re.fullmatch(r"(.+?)\s*\w+", " ".join(param.split())).group(1)
            types.append(C_TYPES[ctype.replace(" *", "*")])
        sigs[fn] = types
    return sigs


@pytest.mark.parametrize("name", sorted(cuda_libs.LIBRARIES))
def test_declared_argtypes_match_the_c_signatures(name):
    lib = cuda_libs.LIBRARIES[name]
    sigs = c_signatures(lib.source.read_text())
    assert sorted(sigs) == sorted(lib.functions), "declared and extern \"C\" functions differ"
    for fn, argtypes in lib.functions.items():
        assert list(argtypes) == sigs[fn], fn


def test_every_cuda_source_is_declared_once():
    declared = sorted(lib.source.name for lib in cuda_libs.LIBRARIES.values())
    assert declared == sorted(p.name for p in cuda_libs.CSRC.glob("*.cu"))


def test_shared_lib_builds_atomically(tmp_path):
    src = tmp_path / "add.c"
    src.write_text("int add(int a, int b) { return a + b; }\n")
    path = tmp_path / "build" / "libadd.so"
    shared_lib.build({path: ["g++", "-O2", "-shared", "-fPIC", "-x", "c", str(src)]},
                     timeout=300)
    assert sorted(p.name for p in path.parent.iterdir()) == ["libadd.log", "libadd.so"]
    add = ctypes.CDLL(str(path)).add
    add.argtypes, add.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    assert add(2, 40) == 42
    # a failing compiler raises with its log and leaves no temporary file
    bad = tmp_path / "build" / "libbad.so"
    with pytest.raises(shared_lib.BuildError, match="g\\+\\+ failed to build"):
        shared_lib.build({bad: ["g++", "-shared", "-x", "c", str(tmp_path / "none.c")]},
                         timeout=300)
    assert sorted(p.name for p in path.parent.iterdir()) == ["libadd.log", "libadd.so",
                                                            "libbad.log"]
