"""The native data loader: ctypes bindings for ``csrc/ia_data.cpp``.

Port of ``item_alignment_tpu/data/native_loader.py``, with the same five
functions and the same results:

- ``tsv_index``: per-field byte offsets of a TSV file and the field count
  of each line;
- ``read_tsv_fast``: the rows of a TSV file (lines end at ``\\n`` only, so a
  ``\\r`` stays in the last field; only empty lines are skipped, a
  whitespace-only line is a row), sliced from the mapped file;
- ``format_rows``: ``[n, d]`` floats -> comma-joined ``%.9g`` rows in fp32,
  NaN, +inf and -inf spelled ``NaN``, ``Infinity`` and ``-Infinity`` as
  ``json.dump`` spells them;
- ``read_embedding_spans``: ``[(id, array text)]`` of an ``{"id": [floats]}``
  JSON map, the text sliced from the file with spaces and newlines taken
  out, or None when the scan refuses the file (an escaped key, nesting, a
  value that is not an array) or it is empty: the caller then reads it with
  ``json.load``;
- ``count_lines``: the newlines of a file.

The library is built by ``g++ -O3 -shared -fPIC`` at first use, never at
import, into ``build/native/libia_data-<hash of the source and flags>.so``
(written to a temporary file and moved into place, so processes that build
at the same moment do not clash).  Without a working ``g++`` every call
raises ``RuntimeError`` with the compiler's log; nothing falls back to
Python.  The plain Python versions below (``read_tsv_reference``,
``format_rows_reference``) are for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import mmap
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from item_alignment_torch.utils import logger

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ia_data.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
# the library's path and the seconds its build took (0 when cached)
BUILD_INFO: dict = {}


def _compiler() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found: it is needed to build the native "
                           f"data loader ({SOURCE})")
    return found


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libia_data-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    path = library_path()
    if path.exists():
        BUILD_INFO.update(path=str(path), seconds=0.0)
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    BUILD_INFO.update(path=str(path), seconds=time.perf_counter() - t0)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    lib.tsv_index.restype = i64
    lib.tsv_index.argtypes = [ctypes.c_char_p, p64, p64, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
    lib.count_char.restype = i64
    lib.count_char.argtypes = [ctypes.c_char_p, ctypes.c_char]
    lib.format_float_rows.restype = i64
    lib.format_float_rows.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_char, ctypes.c_void_p, i64,
        ctypes.c_void_p]
    lib.emb_json_spans.restype = i64
    lib.emb_json_spans.argtypes = [ctypes.c_char_p, p64, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def tsv_index(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(field starts, field ends, fields per line), byte offsets."""
    lib = get_lib()
    n_lines, n_fields = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.tsv_index(path.encode(), ctypes.byref(n_lines),
                       ctypes.byref(n_fields), None, None, None)
    if rc != 0:
        raise RuntimeError(f"tsv_index({path}) failed: {rc}")
    starts = np.empty(n_fields.value, np.int64)
    ends = np.empty(n_fields.value, np.int64)
    counts = np.empty(n_lines.value, np.int64)
    rc = lib.tsv_index(path.encode(), ctypes.byref(n_lines),
                       ctypes.byref(n_fields), _ptr(starts), _ptr(ends),
                       _ptr(counts))
    if rc != 0:
        raise RuntimeError(f"tsv_index({path}) failed: {rc}")
    return starts, ends, counts


def read_tsv_fast(path: str) -> List[Tuple[str, ...]]:
    """The rows of a UTF-8 TSV file, by the native offset scan."""
    if os.path.getsize(path) == 0:
        return []
    starts, ends, counts = tsv_index(path)
    rows: List[Tuple[str, ...]] = []
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as mm:
        idx = 0
        for c in counts.tolist():
            fields = tuple(mm[s:e].decode("utf-8") for s, e in
                           zip(starts[idx:idx + c].tolist(),
                               ends[idx:idx + c].tolist()))
            idx += c
            if len(fields) > 1 or fields[0]:
                rows.append(fields)
    return rows


def format_rows(mat: np.ndarray, sep: str = ",",
                chunk: int = 4096) -> List[str]:
    """``[n, d]`` floats -> ``sep``-joined ``%.9g`` rows of their fp32
    values, through the native formatter, ``chunk`` rows at a time (the
    staging buffer takes 16 bytes a value, the widest ``%.9g``, + 64)."""
    lib = get_lib()
    mat = np.ascontiguousarray(mat, np.float32)
    if mat.ndim != 2:
        raise ValueError(f"expected [n, d], got {mat.shape}")
    n, d = mat.shape
    out: List[str] = []
    for i in range(0, n, chunk):
        sub = np.ascontiguousarray(mat[i:i + chunk])
        cap = int(sub.size) * 16 + 64
        buf = np.empty(cap, np.uint8)
        ends = np.empty(len(sub), np.int64)
        total = lib.format_float_rows(_ptr(sub), len(sub), d, sep.encode()[:1],
                                      _ptr(buf), cap, _ptr(ends))
        if total < 0:
            raise RuntimeError(f"format_float_rows failed: {total}")
        raw = buf[:total].tobytes()
        start = 0
        for e in ends.tolist():
            out.append(raw[start:e].decode("ascii"))
            start = e
    return out


def read_embedding_spans(path: str) -> Optional[List[Tuple[str, str]]]:
    """``[(id, "v,v,...")]`` of an ``{"id": [floats...]}`` JSON map, each
    array's text sliced from the file with spaces and newlines taken out
    (a ``json.dump``'ed file's ``", "`` becomes the TSVs' ``","``).  None
    for an empty file or one the scan refuses: read it with ``json.load``
    then."""
    if os.path.getsize(path) == 0:
        return None
    lib = get_lib()
    n = ctypes.c_int64()
    rc = lib.emb_json_spans(path.encode(), ctypes.byref(n),
                            None, None, None, None)
    if rc != 0:
        logger.warning(f"emb_json_spans({path}) -> {rc}; using json.load")
        return None
    ks, ke, vs, ve = (np.empty(n.value, np.int64) for _ in range(4))
    rc = lib.emb_json_spans(path.encode(), ctypes.byref(n), _ptr(ks),
                            _ptr(ke), _ptr(vs), _ptr(ve))
    if rc != 0:
        return None
    out: List[Tuple[str, str]] = []
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as mm:
        for a, b, c, e in zip(ks.tolist(), ke.tolist(), vs.tolist(),
                              ve.tolist()):
            val = mm[c:e].decode("ascii")
            if " " in val or "\n" in val:
                val = "".join(val.split())
            out.append((mm[a:b].decode("utf-8"), val))
    return out


def count_lines(path: str) -> int:
    """The number of ``\\n`` bytes of a file."""
    n = int(get_lib().count_char(path.encode(), b"\n"))
    if n < 0:
        raise RuntimeError(f"count_char({path}) failed: {n}")
    return n


# ------------------------------------------------------------ plain versions
def read_tsv_reference(path: str) -> List[Tuple[str, ...]]:
    """Plain Python version of ``read_tsv_fast``."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines.pop()
    return [tuple(field.decode("utf-8") for field in line.split(b"\t"))
            for line in lines if line]


def _plain_value(x: float) -> str:
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    return f"{x:.9g}"


def format_rows_reference(mat: np.ndarray, sep: str = ",") -> List[str]:
    """Plain Python version of ``format_rows``."""
    mat = np.asarray(mat, np.float32)
    if mat.ndim != 2:
        raise ValueError(f"expected [n, d], got {mat.shape}")
    return [sep.join(map(_plain_value, row)) for row in mat.tolist()]
