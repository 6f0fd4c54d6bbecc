"""Compiler runs shared by the port's two native libraries: the CUDA
kernels of ``csrc/`` (``ops/_build.py``, ``nvcc``) and the host data library
of ``data/native`` (``g++``).

Each library goes to ``build/`` at the repository root (ignored by git)
under a name that carries :func:`hash_of` its sources and flags, so a stale
library is never loaded and a current one is reused.  :func:`build_locked`
compiles under a file lock, so concurrent processes on a cold ``build/`` run
one compiler, and keeps the compiler's output beside the library as
``.log``.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Iterator, List

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def hash_of(flags, paths) -> str:
    """A short hash of compiler flags and source files (names and bytes)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def file_lock(path: Path) -> Iterator[None]:
    """Hold an exclusive ``flock`` on ``path`` (created with its folder)
    for the body: one process at a time across the machine."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def build_locked(out: Path, command_for: Callable[[Path], List[str]]) -> Path:
    """Run the compiler command ``command_for(tmp)`` unless ``out`` exists,
    under a file lock (another process may be building it), and keep the
    compiler's output beside the library as ``.log``; return ``out``."""
    if out.is_file():
        return out
    with file_lock(out.parent / f".{out.name}.lock"):
        if not out.is_file():
            _compile(out, command_for)
    return out


def _compile(out: Path, command_for) -> None:
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = command_for(Path(tmp))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        # the compiler's report (nvcc's ptxas -v: registers, shared memory
        # and spills of each kernel)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
