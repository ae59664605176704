"""Build and load the port's hand-written CUDA kernels.

Each kernel source in ``paddle_tpu_torch/csrc/`` has a plain C interface
and no PyTorch headers.  :func:`build` compiles one with ``nvcc`` for
sm_90a into ``build/`` at the repository root, under a name keyed by the
content hash of the source and of the ``*.cuh`` headers beside it
(``build/lib<stem>-<hash>.so``, so an edited source or header rebuilds),
and keeps the compiler's ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) beside the library, in
``<library>.ptxas.txt``.  :func:`load` builds a source at first use and
binds it with ``ctypes``, once per process.  Nothing here runs when a
module is imported: the CPU tests import every module, and this machine
may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA toolkit is needed to build the port's kernels for a CUDA "
        "tensor")


def _digest(source: str) -> str:
    """Content hash of ``source`` and of every ``*.cuh`` header in its
    directory (the headers a source may include), in name order."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source),
                                            "*.cuh")))
    for path in [source] + headers:
        with open(path, "rb") as fh:
            data = fh.read()
        h.update(f"{os.path.basename(path)}:{len(data)}:".encode())
        h.update(data)
    return h.hexdigest()[:16]


def build(source: str) -> str:
    """Compile ``source`` (a path) for sm_90a into ``build/`` unless the
    library of its current content (and its headers') is there; return
    the library's path."""
    digest = _digest(source)
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{stem}: nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    with open(path + ".ptxas.txt", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def load(source: str,
         signatures: Dict[str, Tuple[Sequence, object]]) -> ctypes.CDLL:
    """The ``ctypes`` library of ``source``, built at first use, with each
    function in ``signatures`` ({name: (argtypes, restype)}) declared.
    One library per source per process."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _libs[source] = lib
        return lib
