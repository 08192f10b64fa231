"""Knowledge-graph embedding models.

Port of ``item_alignment_tpu/kge/models.py``: the eleven models of
``make_kge_model`` (translational TransE, PKGM, TransH, TransR, TransD;
bilinear DistMult, RESCAL, HolE, ComplEx, Analogy; ConvKB), their pointwise
``score``, ``forward`` with the negatives, ``normalize_parameters`` and the
all-candidate scorers of link prediction.

- The parameters are a dict of fp32 tensors, named as the JAX package's
  pytree, so an ``.npz`` of one loads as the other.
- Rows are read with ``models/layers.py:take_rows``, whose gradient sums
  duplicates in a fixed order, and each table is read once a call, so a
  step holds one dense gradient a table.
- The all-candidate products are plain ``torch.matmul`` (the JAX package
  computes them outside any Pallas kernel).  L2 translational distances use
  the ``||x - e||^2 = ||x||^2 - 2 x.e + ||e||^2`` expansion instead of a
  [B, n_ent, dim] broadcast; the models without an expansion score the
  candidates in chunks of 4096.  TF32 must stay off: the expansion loses
  digits to cancellation.

Scores follow torchkge's conventions (higher = more plausible):
TransE ``-d(h + r, t)`` (d = L1 or squared L2), PKGM ``-d(h + r, t) -
d(Mh, r)`` with L2-normalised entity rows, DistMult ``<h, r, t>``, RESCAL
``h^T W_r t``, and ComplEx / Analogy / HolE as in Trouillon / Liu / Nickel
et al.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from item_alignment_torch.models.layers import take_rows

Params = Dict[str, torch.Tensor]
KNOWN = ("transe", "pkgm", "transh", "transr", "transd", "distmult",
         "rescal", "hole", "complex", "analogy", "convkb")
CHUNK = 4096  # candidates a chunk of the fallback scorers


def xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (2.0 * limit) - limit


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def dissimilarity(a: torch.Tensor, b: torch.Tensor, kind: str = "L2"
                  ) -> torch.Tensor:
    """torchkge's dissimilarities: L1 = ||a-b||_1, L2 = ||a-b||_2^2
    (squared), and the TorusE variants."""
    if kind == "L1":
        return (a - b).abs().sum(-1)
    if kind == "torus_L1":
        d = (a - b).abs()
        return 2 * torch.minimum(d, 1 - d).sum(-1)
    if kind == "torus_L2":
        d = (a - b) ** 2
        return 4 * torch.minimum(d, 1 - d).sum(-1)
    if kind == "torus_eL2":
        d = torch.minimum(a - b, 1 - (a - b))
        return (2 * (1 - torch.cos(2 * math.pi * d))).sum(-1) / 4
    return ((a - b) ** 2).sum(-1)


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _rows(table: torch.Tensor, *ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One read of ``table`` for several id vectors, split back."""
    out = take_rows(table, torch.cat(ids))
    return out.split([len(i) for i in ids])


@dataclasses.dataclass
class KGEModel:
    """A KGE model: init / score / normalise, and the candidate scorers."""

    name: str
    n_ent: int
    n_rel: int
    emb_dim: int
    dissimilarity_type: str = "L2"

    # ---------------------------------------------------------------- init
    def init_params(self, gen: torch.Generator) -> Params:
        """Fresh parameters drawn from ``gen``, on its device."""
        d, ne, nr = self.emb_dim, self.n_ent, self.n_rel
        p = {"ent_emb": l2_normalize(xavier_uniform(gen, (ne, d))),
             "rel_emb": xavier_uniform(gen, (nr, d))}
        if self.name == "pkgm":
            p["rel_emb"] = l2_normalize(p["rel_emb"])
            p["proj_mat"] = xavier_uniform(gen, (d, d))
        elif self.name == "transh":
            p["norm_vect"] = l2_normalize(xavier_uniform(gen, (nr, d)))
        elif self.name == "transr":
            p["proj_mat"] = xavier_uniform(gen, (nr, d, d))
        elif self.name == "transd":
            p["ent_proj"] = xavier_uniform(gen, (ne, d))
            p["rel_proj"] = xavier_uniform(gen, (nr, d))
        elif self.name == "rescal":
            p["rel_mat"] = xavier_uniform(gen, (nr, d, d))
            del p["rel_emb"]
        elif self.name in ("complex", "analogy"):
            # real/imaginary halves stored as separate tables
            p["ent_emb_im"] = xavier_uniform(gen, (ne, d))
            p["rel_emb_im"] = xavier_uniform(gen, (nr, d))
            if self.name == "analogy":
                # the scalar (DistMult-like) component
                p["ent_emb_s"] = xavier_uniform(gen, (ne, d))
                p["rel_emb_s"] = xavier_uniform(gen, (nr, d))
        elif self.name == "convkb":
            n_filters = 32
            p["conv_w"] = torch.randn((n_filters, 3), generator=gen,
                                      device=gen.device) * 0.1
            p["conv_b"] = torch.zeros((n_filters,), device=gen.device)
            p["fc_w"] = xavier_uniform(gen, (d * n_filters, 1))
        return p

    # --------------------------------------------------------------- score
    def score(self, params: Params, h_idx, r_idx, t_idx) -> torch.Tensor:
        """[B] scores of the facts (h, r, t)."""
        name, dt = self.name, self.dissimilarity_type
        E = params["ent_emb"]
        h_idx, r_idx, t_idx = (_ids(x, E.device) for x in (h_idx, r_idx,
                                                           t_idx))
        Eh, Et = _rows(E, h_idx, t_idx)
        r = take_rows(params["rel_emb"], r_idx) if "rel_emb" in params \
            else None
        if name == "transe":
            return -dissimilarity(l2_normalize(Eh) + r, l2_normalize(Et), dt)
        if name == "pkgm":
            h, t = l2_normalize(Eh), l2_normalize(Et)
            hp = h @ params["proj_mat"].T
            return -dissimilarity(h + r, t, dt) - dissimilarity(hp, r, dt)
        if name == "transh":
            w = l2_normalize(take_rows(params["norm_vect"], r_idx))
            h, t = l2_normalize(Eh), l2_normalize(Et)
            h = h - (h * w).sum(-1, keepdim=True) * w
            t = t - (t * w).sum(-1, keepdim=True) * w
            return -dissimilarity(h + r, t, dt)
        if name == "transr":
            M = take_rows(params["proj_mat"], r_idx)  # [B, d, d]
            h = torch.einsum("bd,bde->be", l2_normalize(Eh), M)
            t = torch.einsum("bd,bde->be", l2_normalize(Et), M)
            return -dissimilarity(l2_normalize(h) + r, l2_normalize(t), dt)
        if name == "transd":
            hp, tp = _rows(params["ent_proj"], h_idx, t_idx)
            rp = take_rows(params["rel_proj"], r_idx)
            h, t = l2_normalize(Eh), l2_normalize(Et)
            h = l2_normalize(h + (h * hp).sum(-1, keepdim=True) * rp)
            t = l2_normalize(t + (t * tp).sum(-1, keepdim=True) * rp)
            return -dissimilarity(h + r, t, dt)
        if name == "distmult":
            return (Eh * r * Et).sum(-1)
        if name == "rescal":
            W = take_rows(params["rel_mat"], r_idx)
            return torch.einsum("bd,bde,be->b", Eh, W, Et)
        if name == "hole":
            # circular correlation through the real FFT (Nickel et al. 2016)
            fh = torch.fft.rfft(Eh, dim=-1)
            ft = torch.fft.rfft(Et, dim=-1)
            corr = torch.fft.irfft(torch.conj(fh) * ft, n=self.emb_dim,
                                   dim=-1)
            return (r * corr).sum(-1)
        if name in ("complex", "analogy"):
            hi, ti = _rows(params["ent_emb_im"], h_idx, t_idx)
            ri = take_rows(params["rel_emb_im"], r_idx)
            c = (Eh * r * Et + hi * r * ti + Eh * ri * ti
                 - hi * ri * Et).sum(-1)
            if name == "complex":
                return c
            hs, ts = _rows(params["ent_emb_s"], h_idx, t_idx)
            rs = take_rows(params["rel_emb_s"], r_idx)
            return (hs * rs * ts).sum(-1) + c
        if name == "convkb":
            x = torch.stack([Eh, r, Et], dim=-1)  # [B, d, 3]
            conv = torch.einsum("bdk,fk->bdf", x, params["conv_w"]) \
                + params["conv_b"]
            feat = torch.relu(conv).reshape(x.shape[0], -1)
            return (feat @ params["fc_w"])[:, 0]
        raise ValueError(f"unknown KGE model {name}")

    def forward(self, params: Params, h, t, r, nh, nt
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(positive scores, negative scores), the positives tiled to the
        negatives' count (torchkge's n_neg repeat).  Both are scored in one
        call, so each table is read once."""
        E = params["ent_emb"]
        h, t, r, nh, nt = (_ids(x, E.device) for x in (h, t, r, nh, nt))
        nr = r if nh.shape == r.shape else r.repeat(nh.shape[0] // r.shape[0])
        s = self.score(params, torch.cat([h, nh]), torch.cat([r, nr]),
                       torch.cat([t, nt]))
        pos, neg = s[: h.shape[0]], s[h.shape[0]:]
        if neg.shape[0] != pos.shape[0]:
            pos = pos.repeat(neg.shape[0] // pos.shape[0])
        return pos, neg

    # ------------------------------------------------------- normalisation
    def normalize_parameters(self, params: Params) -> Params:
        p = dict(params)
        if self.name in ("transe", "pkgm", "transh", "transr", "transd"):
            p["ent_emb"] = l2_normalize(p["ent_emb"])
        if self.name == "transh":
            p["norm_vect"] = l2_normalize(p["norm_vect"])
        return p

    def get_embeddings(self, params: Params
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        p = self.normalize_parameters(params)
        return p["ent_emb"], p.get("rel_emb")

    # -------------------------------------------- all-candidate LP scoring
    def scores_all_tails(self, params: Params, h_idx, r_idx) -> torch.Tensor:
        """[B, n_ent] scores of (h, r, every candidate tail)."""
        name, dt = self.name, self.dissimilarity_type
        E = params["ent_emb"]
        h_idx, r_idx = _ids(h_idx, E.device), _ids(r_idx, E.device)
        if name in ("transe", "pkgm") and dt == "L2":
            h = l2_normalize(E[h_idx])
            r = params["rel_emb"][r_idx]
            x = h + r
            scores = -((x * x).sum(-1, keepdim=True) - 2.0 * (x @ E.T)
                       + (E * E).sum(-1)[None, :])
            if name == "pkgm":
                rel_term = dissimilarity(h @ params["proj_mat"].T, r, dt)
                scores = scores - rel_term[:, None]
            return scores
        if name == "distmult":
            return (E[h_idx] * params["rel_emb"][r_idx]) @ E.T
        if name == "rescal":
            hW = torch.einsum("bd,bde->be", E[h_idx],
                              params["rel_mat"][r_idx])
            return hW @ E.T
        if name == "complex":
            hr, hi = E[h_idx], params["ent_emb_im"][h_idx]
            rr, ri = params["rel_emb"][r_idx], params["rel_emb_im"][r_idx]
            return ((hr * rr - hi * ri) @ E.T
                    + (hr * ri + hi * rr) @ params["ent_emb_im"].T)
        return self._chunked(params, h_idx, r_idx, "tails")

    def scores_all_heads(self, params: Params, t_idx, r_idx) -> torch.Tensor:
        """[B, n_ent] scores of (every candidate head, r, t)."""
        name, dt = self.name, self.dissimilarity_type
        E = params["ent_emb"]
        t_idx, r_idx = _ids(t_idx, E.device), _ids(r_idx, E.device)
        if name == "transe" and dt == "L2":
            x = l2_normalize(E[t_idx]) - params["rel_emb"][r_idx]
            return -((x * x).sum(-1, keepdim=True) - 2.0 * (x @ E.T)
                     + (E * E).sum(-1)[None, :])
        if name == "pkgm" and dt == "L2":
            # the head candidate is in both terms:
            #   -||hn + r - t||^2 - ||M hn - r||^2,  hn = normalised candidate
            # expanded so that only two [B, n_ent] products are made
            Hn = l2_normalize(E)                                  # [N, d]
            r = params["rel_emb"][r_idx]                          # [B, d]
            y = r - l2_normalize(E[t_idx])                        # [B, d]
            term1 = ((Hn * Hn).sum(-1)[None, :]
                     + (y * y).sum(-1, keepdim=True) + 2.0 * (y @ Hn.T))
            P = Hn @ params["proj_mat"].T                         # [N, d]
            term2 = ((P * P).sum(-1)[None, :]
                     + (r * r).sum(-1, keepdim=True) - 2.0 * (r @ P.T))
            return -term1 - term2
        if name == "distmult":
            return (E[t_idx] * params["rel_emb"][r_idx]) @ E.T
        if name == "complex":
            tr, ti = E[t_idx], params["ent_emb_im"][t_idx]
            rr, ri = params["rel_emb"][r_idx], params["rel_emb_im"][r_idx]
            return ((rr * tr + ri * ti) @ E.T
                    + (rr * ti - ri * tr) @ params["ent_emb_im"].T)
        return self._chunked(params, t_idx, r_idx, "heads")

    def _chunked(self, params: Params, anchor: torch.Tensor,
                 r_idx: torch.Tensor, side: str) -> torch.Tensor:
        """Pointwise scores of every candidate, CHUNK candidates at a time."""
        B, out = anchor.shape[0], []
        for start in range(0, self.n_ent, CHUNK):
            c = torch.arange(start, min(start + CHUNK, self.n_ent),
                             device=anchor.device)
            cand = c[None, :].expand(B, -1).reshape(-1)
            a = anchor[:, None].expand(-1, len(c)).reshape(-1)
            r = r_idx[:, None].expand(-1, len(c)).reshape(-1)
            s = (self.score(params, a, r, cand) if side == "tails"
                 else self.score(params, cand, r, a))
            out.append(s.reshape(B, len(c)))
        return torch.cat(out, dim=1)


def make_kge_model(name: str, n_ent: int, n_rel: int, emb_dim: int,
                   dissimilarity_type: str = "L2") -> KGEModel:
    name = name.lower()
    if name not in KNOWN:
        raise ValueError(f"unknown KGE model {name}; known: {KNOWN}")
    return KGEModel(name, n_ent, n_rel, emb_dim, dissimilarity_type)


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The parameters as float32 numpy arrays (an ``.npz``'s contents)."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in params.items()}


def params_from_numpy(arrays, device=None) -> Params:
    """numpy (or ``.npz``) arrays -> fp32 tensors on ``device``, copies the
    trainer may update in place."""
    return {k: torch.tensor(arrays[k], dtype=torch.float32, device=device)
            for k in (arrays.files if hasattr(arrays, "files") else arrays)}
