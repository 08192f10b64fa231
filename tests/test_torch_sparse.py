"""The port's sparse ops vs the JAX package's, on the CPU.

``spmm``'s forward, ``dx`` and ``dw`` (JAX's through ``jax.grad`` of its
custom VJP) on random graphs made from a seed: lists sorted by destination
and not, whole and in chunks, padded with zero-weight edges, with the
pre-built transpose and without it; within 1e-5.  The numpy helpers give
JAX's arrays exactly.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.ops import sparse as tsp

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.ops import sparse as jsp  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
N, F = 37, 6


def _graph(seed=0, n=N, e=150):
    rs = np.random.RandomState(seed)
    ei = np.unique(rs.randint(0, n, (2, e)), axis=1)
    return jsp.normalize_adjacency(ei, n)


def _case(sort, chunk, pad, transpose, seed=0):
    """(edge_index, edge_weight, transpose or None, chunk) as build-graph
    and finetune-graph make them."""
    ei, ew = _graph(seed)
    ti, tw = jsp.transpose_edges(ei, ew)
    if sort:
        ei, ew = jsp.sort_edges_by_dst(ei, ew)
    if pad:
        target = -(-ei.shape[1] // chunk) * chunk + chunk
        ei, ew = jsp.pad_edges(ei, ew, target, pad_dst=N - 1 if sort else 0)
        ti, tw = jsp.pad_edges(ti, tw, target, pad_dst=N - 1)
    return ei, ew, ((ti, tw) if transpose else None), chunk


CASES = [dict(sort=s, chunk=c, pad=p, transpose=t)
         for s in (True, False) for c, p in ((None, False), (16, True))
         for t in (True, False)]


def _jax_spmm(ei, ew, x, g, chunk, sort, trans):
    def f(w, x):
        y = jsp.spmm(jnp.asarray(ei), w, x, N, chunk, sort,
                     None if trans is None else tuple(map(jnp.asarray, trans)))
        return jnp.sum(y * g), y

    (_, y), (dw, dx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                  has_aux=True))(
        jnp.asarray(ew), jnp.asarray(x))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_spmm_forward_and_grads_match_jax(case):
    ei, ew, trans, chunk = _case(**case)
    rs = np.random.RandomState(1)
    x = rs.randn(N, F).astype(np.float32)
    g = rs.randn(N, F).astype(np.float32)
    ref_y, ref_dx, ref_dw = _jax_spmm(ei, ew, x, g, chunk, case["sort"],
                                      trans)

    adj = tsp.Adjacency(ei, ew, N, chunk, trans, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(ew, requires_grad=True)
    y = tsp.spmm(adj, xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), ref_y, atol=TOL)
    np.testing.assert_allclose(dx.numpy(), ref_dx, atol=TOL)
    np.testing.assert_allclose(dw.numpy(), ref_dw, atol=TOL)


def test_spmm_repeats_bit_for_bit_and_keeps_the_stored_weights():
    ei, ew, trans, chunk = _case(sort=False, chunk=16, pad=True,
                                 transpose=False)
    adj = tsp.Adjacency(ei, ew, N, chunk, trans, device="cpu")
    x = torch.randn(N, F, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    runs = []
    for _ in range(2):
        y = tsp.spmm(adj, x)
        runs.append((y.detach(), torch.autograd.grad(y.sum(), x)[0]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    # the stored weights are the default, and not a leaf of the graph
    assert torch.equal(tsp.spmm(adj, x, torch.from_numpy(ew)).detach(),
                       runs[0][0])


def test_adjacency_plans_once_per_chunk_in_destination_order():
    ei, ew = _graph(2)
    adj = tsp.Adjacency(ei, ew, N, edge_chunk=None, device="cpu")
    # an unsorted list is sorted once, stably, into CSR rows by destination
    # and keeps its map back to the caller's order
    order = np.argsort(ei[1], kind="stable")
    assert torch.equal(adj.a.order, torch.from_numpy(order))
    assert np.array_equal(adj.a.col.numpy(), ei[0][order])
    assert np.array_equal(np.diff(adj.a.crow.numpy()),
                          np.bincount(ei[1], minlength=N))
    assert adj.a.crow.dtype == adj.a.col.dtype == torch.int32
    # without a transpose list, A^T is the swapped list in its own CSR
    assert np.array_equal(np.diff(adj.a_t.crow.numpy()),
                          np.bincount(ei[0], minlength=N))
    si, sw = jsp.sort_edges_by_dst(ei, ew)
    sorted_adj = tsp.Adjacency(si, sw, N, edge_chunk=None, device="cpu")
    assert sorted_adj.a.order is None  # already in row order
    assert sorted_adj.edge_index.dtype == torch.int64
    # a padded, chunked list: the padding sits in the last row, and the
    # chunk bounds dw's products alone
    pi, pw = jsp.pad_edges(si, sw, 192, pad_dst=N - 1)
    padded = tsp.Adjacency(pi, pw, N, edge_chunk=32, device="cpu")
    assert padded.a.order is None and padded.chunk == 32
    assert int(padded.a.crow[-1] - padded.a.crow[-2]) == \
        192 - si.shape[1] + int((si[1] == N - 1).sum())
    with pytest.raises(ValueError, match="edge_chunk"):
        tsp.Adjacency(si, sw, N, edge_chunk=7, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tsp.Adjacency(si, sw, N - 5, device="cpu")


@pytest.mark.parametrize("helper", ["sort", "transpose", "normalize", "pad"])
def test_numpy_helpers_equal_jax(helper):
    rs = np.random.RandomState(3)
    ei = rs.randint(0, N, (2, 90)).astype(np.int32)
    ew = rs.rand(90).astype(np.float32)
    if helper == "sort":
        got, ref = tsp.sort_edges_by_dst(ei, ew), jsp.sort_edges_by_dst(ei, ew)
    elif helper == "transpose":
        got, ref = tsp.transpose_edges(ei, ew), jsp.transpose_edges(ei, ew)
    elif helper == "normalize":
        got = tsp.normalize_adjacency(ei.astype(np.int64), N)
        ref = jsp.normalize_adjacency(ei.astype(np.int64), N)
    else:
        got = tsp.pad_edges(ei, ew, 128, pad_dst=N - 1)
        ref = jsp.pad_edges(ei, ew, 128, pad_dst=N - 1)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
