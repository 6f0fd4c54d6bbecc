"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every source of ``csrc/`` into one shared library
with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/libmdgan_kernels_<hash>.so csrc/*.cu

No PyTorch headers and no ``torch.utils.cpp_extension`` builder: a plain-C
file compiles in seconds, a file that includes ``torch/extension.h`` in
minutes.  The library goes to ``build/`` at the repository root (ignored by
git); its name carries a hash of the sources and flags, so a stale library is
never loaded and a current one is reused; ptxas's resource report is kept
beside it as ``.log``.  Builds take a file lock, so the ranks of a
``torch.distributed`` run starting on a cold ``build/`` run one ``nvcc``
(``utils/build.py``, shared with the host library of ``data/native``).
Nothing is built or loaded until a wrapper first sees a CUDA tensor.

:func:`launch` is the one place that calls a C entry point: it holds the
call to the entry's ``SIGNATURES`` row, raises on a CUDA error and counts
the launch in ``launches``.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional

from mdgan_tpu_torch.utils.build import BUILD_DIR, build_locked, hash_of

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("adam.cu", "sampling.cu", "upfirdn2d.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int, _c_int64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int64, ctypes.c_float)
# C signatures of csrc/*.cu's extern "C" functions (all return cudaError_t as int)
SIGNATURES = {
    "mdgan_adam_f32": [_c_void_p] * 4 + [_c_int64] + [_c_float] * 7 + [_c_void_p],
    "mdgan_adam_f32_bf16m": [_c_void_p] * 4 + [_c_int64] + [_c_float] * 7 + [_c_void_p],
    "mdgan_sample_normalize_u8": [_c_void_p] * 3 + [_c_int64, _c_int, _c_int, _c_int64,
                                                    _c_int, _c_int, _c_void_p],
    "mdgan_upfirdn2d": [_c_void_p, _c_void_p, _c_int, _c_int64] + [_c_int] * 8
                       + [_c_void_p, _c_int, _c_int] + [_c_int] * 8 + [_c_void_p],
}

# kernel launches since the last ``clear()``, by entry point; the FIR's also
# by plan, as "mdgan_upfirdn2d/<plan>"
launches: collections.Counter = collections.Counter()
# the Adam and sampling entry points under the names reports give their counts
REPORT_NAMES = {"adam": "mdgan_adam_f32", "adam_bf16m": "mdgan_adam_f32_bf16m",
                "sampling": "mdgan_sample_normalize_u8"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_candidates() -> List[Path]:
    """Where nvcc is looked for, in order: $CUDA_HOME, torch's CUDA_HOME,
    /usr/local/cuda."""
    homes = []
    if os.environ.get("CUDA_HOME"):
        homes.append(os.environ["CUDA_HOME"])
    try:
        from torch.utils.cpp_extension import CUDA_HOME  # path lookup only
    except ImportError:
        CUDA_HOME = None
    if CUDA_HOME:
        homes.append(CUDA_HOME)
    homes.append("/usr/local/cuda")
    return [Path(h) / "bin" / "nvcc" for h in homes]


def find_nvcc() -> Path:
    for cand in nvcc_candidates():
        if cand.is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (tried " + ", ".join(map(str, nvcc_candidates())) + "); the "
        "CUDA kernels are built with: " + " ".join(command(Path("nvcc"), library_path())))


def source_hash() -> str:
    return hash_of(NVCC_FLAGS, [CSRC / name for name in SOURCES])


def library_path() -> Path:
    return BUILD_DIR / f"libmdgan_kernels_{source_hash()}.so"


def command(nvcc: Path, out: Path) -> List[str]:
    return [str(nvcc), *NVCC_FLAGS, "-o", str(out), *(str(CSRC / s) for s in SOURCES)]


def build() -> Path:
    """Compile ``SOURCES`` into ``libmdgan_kernels_<hash>.so`` unless a
    current one exists; return its path."""
    return build_locked(library_path(), lambda tmp: command(find_nvcc(), tmp))


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.mdgan_cuda_error_string.argtypes = [ctypes.c_int]
            loaded.mdgan_cuda_error_string.restype = ctypes.c_char_p
            _lib = loaded
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        name = lib().mdgan_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")


def launch(name: str, *args, plan: Optional[str] = None) -> None:
    """Call entry point ``name`` with ``args``, refusing before the call a
    count that differs from its ``SIGNATURES`` row; raise on a CUDA error;
    count the launch under ``name`` (and ``name/plan``)."""
    if len(args) != len(SIGNATURES[name]):
        raise TypeError(f"{name} takes {len(SIGNATURES[name])} arguments, got {len(args)}")
    check(getattr(lib(), name)(*args), name)
    launches[name] += 1
    if plan is not None:
        launches[f"{name}/{plan}"] += 1


def reported() -> Dict[str, int]:
    """The Adam and sampling kernels' ``launches`` under ``REPORT_NAMES``."""
    return {key: launches[name] for key, name in REPORT_NAMES.items()}
