"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, at first use, and bound with ``ctypes``.  The
libraries are cached under ``build/kernels/`` by a hash of every source in
``csrc/`` (headers included) and the flags, so an edit anywhere rebuilds
them all.  ``build`` starts one ``nvcc`` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_attention", "flash_blockwise_fwd", "flash_blockwise_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}
# per library: path, build seconds (0 when cached) and nvcc's log
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the attention kernels")


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def build(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load the named kernel libraries."""
    names = list(names)
    tag = _tag()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _LIBS:
            continue
        path = BUILD_DIR / f"libia_{name}-{tag}.so"
        if path.exists():
            BUILD_INFO[name] = dict(path=str(path), seconds=0.0, log="")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        BUILD_INFO[name] = dict(path=str(path),
                                seconds=time.perf_counter() - t0, log=log)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            lib = ctypes.CDLL(BUILD_INFO[name]["path"])
            lib.ia_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ia_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The named library, built on first use (later calls hash nothing)."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build([name])[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ia_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")
