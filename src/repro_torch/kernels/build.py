"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel is a ``.cu`` file under ``kernels/csrc/`` with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes);
the kernels share device code through the ``.cuh`` headers beside them.
At first use a kernel is compiled into ``build/kernels/`` at the root of
the checkout, under a file name keyed on a hash of its sources, the
headers and the flags, so an edit rebuilds it and an unchanged source is
reused.  ``nvcc`` is
looked up on ``PATH``, then under ``CUDA_HOME`` / ``CUDA_PATH``, then in
``/usr/local/cuda``; a missing ``nvcc`` raises with that list.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``; raises ``RuntimeError`` naming where it looked."""
    found = shutil.which("nvcc")
    if found:
        return found
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for root in roots:
        if root:
            cand = pathlib.Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin, $CUDA_PATH/bin or "
        "/usr/local/cuda/bin; the port's CUDA kernels are built from "
        "src/repro_torch/kernels/csrc at first use and need the CUDA toolkit")


def library_path(name: str, sources: tuple[str, ...]) -> pathlib.Path:
    """Where the library of ``sources`` lives, keyed on their content and
    that of every header in ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for src in (*sources, *headers):
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: tuple[str, ...]) -> pathlib.Path:
    """Compile ``sources`` (file names under ``csrc/``) into one shared
    library unless it is already built; returns its path.  ``nvcc``'s
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside it as ``<library>.log``."""
    lib = library_path(name, sources)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)      # atomic: a concurrent build never sees half
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build if needed, then ``ctypes``-load the library (once per process)."""
    return ctypes.CDLL(str(build_library(name, sources)))


def build_log(name: str, sources: tuple[str, ...]) -> str:
    """The ``-Xptxas -v`` report of a built library ('' before a build)."""
    log = library_path(name, sources).with_suffix(".log")
    return log.read_text() if log.is_file() else ""
