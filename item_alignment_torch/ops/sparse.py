"""Sparse (edge-list) ops for the graph model.

Port of ``item_alignment_tpu/ops/sparse.py``.  The adjacency is a COO edge
list, ``edge_index [2, E]`` (src, dst) with ``edge_weight [E]``: messages
flow src -> dst, and ``spmm`` computes ``A @ x``, ``out[d] = sum over the
edges e into d of w_e * x[src_e]``.

The JAX package sums with ``jax.ops.segment_sum``, a scatter-add.  On CUDA a
float scatter-add (``index_add_``) uses atomics, and its sums change from
run to run.  Here ``A`` is a CSR matrix (rows = destinations) and the
product is ``torch.sparse.mm``: cuSPARSE's CSR SpMM on the card, which
repeats bit for bit, and no message buffer at all.  What depends only on
the static edge list is worked out once on the host by ``Adjacency``: a
stable sort by destination (a dst-sorted list keeps its order), the int32
CSR offsets and columns, and the same for ``A^T``.

The backward is JAX's custom VJP: ``dx = A^T g`` is another product, over
the transpose list when one is given (``transpose_edges``) and else over
the list with src and dst swapped, and ``dw_e = x[src_e] . g[dst_e]``, in
chunks of ``edge_chunk`` edges (the only ``[chunk, F]`` buffer left).  No
autograd gather and so no scatter in the backward.

The numpy helpers (``sort_edges_by_dst``, ``transpose_edges``,
``normalize_adjacency``, ``pad_edges``) are copies of the JAX package's and
give its arrays exactly.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from item_alignment_torch.device import resolve_device


@dataclass
class Csr:
    """One edge list as a CSR matrix's structure, on the device.

    ``crow`` [n + 1] and ``col`` [E] int32 (the sources, in destination
    order); ``order`` [E] int64, the caller's position of each entry (None
    when the list is already sorted by destination)."""

    crow: torch.Tensor
    col: torch.Tensor
    order: Optional[torch.Tensor]
    n: int

    def matrix(self, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The ``[n, n]`` CSR matrix with weights ``w`` (caller's order)."""
        values = (w if self.order is None else w[self.order]).to(dtype)
        with warnings.catch_warnings():  # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(self.crow, self.col, values,
                                           (self.n, self.n),
                                           check_invariants=False)


def plan_csr(edge_index: np.ndarray, n_nodes: int, device) -> Csr:
    """Sort ``edge_index`` by destination (stable) and count its rows, on
    the host, once."""
    src, dst = np.asarray(edge_index, np.int64)
    order = np.argsort(dst, kind="stable")
    crow = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                      minlength=n_nodes))])

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    identity = bool(np.array_equal(order, np.arange(len(order))))
    return Csr(crow=dev(crow, np.int32), col=dev(src[order], np.int32),
               order=None if identity else dev(order, np.int64), n=n_nodes)


class Adjacency:
    """A static edge list planned once for ``spmm``.

    ``edge_index [2, E]`` and ``edge_weight [E]`` (numpy or tensors),
    ``n_nodes``; ``edge_chunk`` bounds the ``[chunk, F]`` products of
    ``dw`` and, as in JAX, must divide E (``pad_edges``); ``transpose``,
    the pre-built (``edge_index_t``, ``edge_weight_t``) of
    ``transpose_edges``, serves the backward's ``A^T g`` (without it the
    backward runs over the swapped list).  ``device`` None means
    ``"cuda"``, as for the models."""

    def __init__(self, edge_index, edge_weight, n_nodes: int,
                 edge_chunk: Optional[int] = None,
                 transpose: Optional[Tuple] = None,
                 device: Optional[Union[str, torch.device]] = None):
        device = resolve_device(device)
        ei = np.asarray(torch.as_tensor(edge_index).cpu()).astype(np.int64)
        self.n_nodes, self.n_edges = int(n_nodes), ei.shape[1]
        self.chunk = (self.n_edges if edge_chunk is None
                      or edge_chunk >= self.n_edges else int(edge_chunk))
        if self.n_edges % max(self.chunk, 1):
            raise ValueError(f"{self.n_edges} edges not divisible by "
                             f"edge_chunk={self.chunk}; pad with pad_edges "
                             "first")
        if ei.size and (ei.min() < 0 or ei.max() >= self.n_nodes):
            raise ValueError(f"edge ids outside [0, {self.n_nodes})")
        self.edge_index = torch.from_numpy(ei).to(device)  # for dw
        self.weight = torch.as_tensor(edge_weight).to(device, torch.float32)
        self.a = plan_csr(ei, self.n_nodes, device)
        if transpose is not None:
            ti, tw = transpose
            self.a_t = plan_csr(np.asarray(torch.as_tensor(ti).cpu()),
                                self.n_nodes, device)
            self.t_weight = torch.as_tensor(tw).to(device, torch.float32)
        else:
            self.a_t = plan_csr(ei[::-1], self.n_nodes, device)
            self.t_weight = None


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, adj):
        ctx.adj = adj
        ctx.save_for_backward(x, w)
        return torch.sparse.mm(adj.a.matrix(w, x.dtype), x)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            tw = w if adj.t_weight is None else adj.t_weight
            dx = torch.sparse.mm(adj.a_t.matrix(tw, g.dtype), g)
        if ctx.needs_input_grad[1]:
            src, dst = adj.edge_index
            c = max(adj.chunk, 1)
            parts = [(x[src[s: s + c]] * g[dst[s: s + c]]).sum(-1)
                     for s in range(0, adj.n_edges, c)]
            dw = (torch.cat(parts) if parts else w.new_zeros(0)).to(w.dtype)
        return dx, dw, None


def spmm(adj: Adjacency, x: torch.Tensor,
         edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A @ x`` (``x`` [n, F]) over ``adj``'s edges; ``edge_weight`` [E],
    in the caller's edge order, replaces the stored weights (its gradient
    is ``dw``)."""
    w = adj.weight if edge_weight is None else edge_weight
    return _Spmm.apply(x, w, adj)


def sort_edges_by_dst(edge_index: np.ndarray, edge_weight: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable-sort a COO edge list by destination (offline, once)."""
    order = np.argsort(np.asarray(edge_index)[1], kind="stable")
    return (np.asarray(edge_index)[:, order],
            np.asarray(edge_weight)[order])


def transpose_edges(edge_index: np.ndarray, edge_weight: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The swapped (dst, src) edge list, sorted by ITS destination: the
    backward pass's adjacency (offline, once)."""
    swapped = np.stack([np.asarray(edge_index)[1],
                        np.asarray(edge_index)[0]])
    return sort_edges_by_dst(swapped, edge_weight)


def normalize_adjacency(edge_index: np.ndarray, n_nodes: int,
                        add_self_loops: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric GCN normalization D^-1/2 (A + I) D^-1/2 in numpy
    (offline, once)."""
    src, dst = edge_index
    if add_self_loops:
        loops = np.arange(n_nodes)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    deg = np.bincount(dst, minlength=n_nodes).astype(np.float32)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = dinv[src] * dinv[dst]
    return np.stack([src, dst]).astype(np.int32), w.astype(np.float32)


def pad_edges(edge_index: np.ndarray, edge_weight: np.ndarray,
              target_edges: int, pad_dst: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the edge list to a static size with zero-weight (0, pad_dst)
    edges.  For dst-sorted lists pass ``pad_dst=n_nodes-1`` so the padding
    keeps the list sorted."""
    e = edge_index.shape[1]
    if target_edges < e:
        raise ValueError(f"target {target_edges} < {e} edges")
    pad = target_edges - e
    pad_block = np.zeros((2, pad), edge_index.dtype)
    pad_block[1, :] = pad_dst
    ei = np.concatenate([edge_index, pad_block], 1)
    ew = np.concatenate([edge_weight, np.zeros(pad, edge_weight.dtype)])
    return ei, ew
