"""A reader of the msgpack files that ``flax.serialization`` writes.

The JAX package saves parameters with ``flax.serialization.to_bytes``
(``engine/checkpoint.py:save_params``: ``best_f1.msgpack``,
``bert_align.msgpack``, ``coca_pretrain.msgpack``, ...).  This module
decodes that subset of msgpack without the ``msgpack`` or ``flax``
packages:

- maps (str keys), arrays, str, bin, nil, bool, ints and floats;
- ext 1, an ndarray: a msgpack ``(shape, dtype name, C-order bytes)``;
  ``bfloat16`` (which numpy lacks) is read as uint16 and viewed as
  ``torch.bfloat16``;
- ext 3, a numpy scalar, in the same encoding;
- flax's chunked arrays, the maps ``{"__msgpack_chunked_array__": True,
  "shape": {"0": d0, ...}, "chunks": {"0": flat0, ...}}`` that it writes
  for arrays over ``MAX_CHUNK_SIZE`` (2**30) bytes.

Arrays come back as CPU tensors (on the file's buffer where it is aligned
to 16 bytes, else copied); scalars as 0-d tensors.  A file that does not
decode raises a ``ValueError`` that names it.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.mv):
            raise ValueError(f"truncated at byte {self.pos} (wants {n} more)")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin),
                 0xC6: (">I", self.bin), 0xD9: (">B", self.str),
                 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext),
                 0xC9: (">I", self.ext)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at byte "
                         f"{self.pos - 1}")

    def bin(self, n: int) -> memoryview:
        return self.take(n)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            out[key] = self.value()
        return out

    def ext(self, n: int) -> torch.Tensor:
        code = self.unpack(">b")
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        shape, name, data = self.value()
        if self.pos != end:
            raise ValueError(f"ext {code} payload ends at {self.pos}, "
                             f"not {end}")
        arr = _ndarray(shape, name, data)
        return arr.reshape(()) if code == EXT_NPSCALAR else arr


def _ndarray(shape, name, data) -> torch.Tensor:
    if not (isinstance(shape, list) and isinstance(name, str)
            and isinstance(data, memoryview)):
        raise ValueError("an ndarray ext is not (shape, dtype name, bytes)")
    dtype = np.dtype(np.uint16 if name == "bfloat16" else name)
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(data):
        raise ValueError(f"{len(data)} bytes for a {name} array of shape "
                         f"{tuple(shape)}")
    if count == 0:
        arr = torch.from_numpy(np.zeros(shape, dtype))
    else:
        arr = torch.from_numpy(np.frombuffer(data, dtype).reshape(shape))
        if arr.data_ptr() % 16:  # the bytes sit anywhere in the file
            arr = arr.clone()
    return arr.view(torch.bfloat16) if name == "bfloat16" else arr


def _unchunk(node: Any) -> Any:
    """flax's chunked array maps back into arrays, everywhere in the
    tree."""
    if isinstance(node, dict):
        if node.get(CHUNKED) is True:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_unchunk(v) for v in node]
    return node


def restore(data) -> Any:
    """The tree of one msgpack document (``flax.serialization.
    msgpack_restore``'s tree, with tensors for arrays).  ``data`` should be
    writable (a ``bytearray``) for the tensors to share it."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.mv):
        raise ValueError(f"{len(reader.mv) - reader.pos} bytes after the "
                         "msgpack document")
    try:
        return _unchunk(tree)
    except (KeyError, TypeError, AttributeError, RuntimeError) as e:
        raise ValueError(f"a malformed chunked array: {e!r}") from e


def read_flax_msgpack(path: str) -> Any:
    """The tree of the Flax msgpack file at ``path``; a malformed file
    raises a ``ValueError`` that names it."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    try:
        return restore(data)
    except (ValueError, struct.error, UnicodeDecodeError, RecursionError,
            TypeError) as e:
        raise ValueError(f"{path}: not a Flax msgpack file ({e})") from e

