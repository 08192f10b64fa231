"""The multimodal RobertaImage family: backbone, one-tower, two-tower.

Port of the RoBERTa+image towers of ``item_alignment_tpu/models/
multimodal.py`` (``RobertaImageBackbone``, ``RobertaImageOneTower``,
``RobertaImageTwoTower``).  Image embeddings (``image_hidden_size`` floats
an item, from an image tower run offline) are spliced over the
``[unused99]`` token positions (``ensemble == "begin"``) or concatenated at
the classification head (``"end"``).  The constructors take ``device``
(None means ``"cuda"``) and ``seed`` as the text models of
``models/text.py`` do, and parameter names follow the Flax tree.

CoCa, the port of the CoCa half (``rotary_freqs``, ``swiglu``,
``ParallelTransformerBlock``, ``CrossAttention``, ``MultimodalDecoder``,
``CoCaModel``, ``CoCaForPretraining``, ``CoCaForItemAlignment``):

- The blocks' LayerNorms are flax's with no bias and eps 1e-6.
- ``ParallelTransformerBlock`` splits one fused projection into q, k, v and
  the feed-forward input, in that order; one key/value head (multi-query);
  rotary positions on q and k.  Under the bf16 policy q and k are bf16 and
  the rotary angles fp32, so, as in JAX, the product promotes and the
  scores, softmax and attention output are fp32.  The causal and padding
  masks fill with ``finfo(dtype).min`` of the scores' dtype.
- The decoder's attention (and ``CrossAttention``'s) is plain matrix
  products, as the JAX package's einsums are: no kernel.  The text encoder
  is ``RobertaBackbone`` (kernels #1-#3 on the card) and the image encoder
  the ``ViT`` of ``models/image.py`` in fp32 (the JAX package gives it no
  dtype), shaped by the config.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.device import resolve_device
from item_alignment_torch.models.embeddings import ImageSpliceEmbeddings
from item_alignment_torch.models.encoder import TransformerEncoder
from item_alignment_torch.models.heads import (
    TwoTowerClassificationHead,
    VecSimClassificationHead,
)
from item_alignment_torch.models.image import ViT, init_image_weights
from item_alignment_torch.models.layers import Dense, LayerNorm
from item_alignment_torch.models.losses import cross_entropy_loss, pair_loss
from item_alignment_torch.models.outputs import PairClassifierOutput
from item_alignment_torch.models.text import (
    Device,
    RobertaBackbone,
    _encode,
    _initialise,
    _OneTowerHead,
    _two_tower_output,
)
from item_alignment_torch.ops.dropout import fold_seed


class RobertaImageBackbone(nn.Module):
    """Image-splice embeddings + encoder; returns all hidden states in
    fp32 (the encoder in bf16 under ``dtype="bfloat16"``)."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.embeddings = ImageSpliceEmbeddings(config)
            self.encoder = TransformerEncoder(config)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, image_embeds, attention_mask=None,
                token_type_ids=None, position_ids=None, image_indices=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        hidden = self.embeddings(input_ids, image_embeds, token_type_ids,
                                 position_ids, attention_mask, image_indices,
                                 deterministic, fold_seed(dropout_seed, 0))
        return _encode(self, hidden, attention_mask, deterministic,
                       dropout_seed)


class RobertaImageOneTower(nn.Module):
    """``[CLS] [IMG] [SEP] src [SEP] [IMG] [SEP] tgt [SEP]`` with both
    images spliced in (``begin``), or the plain pair with the images at the
    head (``end``).  The vec_sim tgt position is ``item_seq_len``, which
    does not count the ``[IMG] [SEP]`` prefix, as in the JAX package."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = RobertaImageBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.head = _OneTowerHead(config, config.item_seq_len)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, src_image_embeds, tgt_image_embeds,
                attention_mask=None, token_type_ids=None, position_ids=None,
                image_indices=None, labels=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        images = (src_image_embeds, tgt_image_embeds)
        states = self.roberta(input_ids, images, attention_mask,
                              token_type_ids, position_ids, image_indices,
                              deterministic, fold_seed(dropout_seed, 0))
        return self.head(states, labels, None, deterministic,
                         fold_seed(dropout_seed, 1),
                         images if self.config.ensemble == "end" else None)


class RobertaImageTwoTower(nn.Module):
    """Two shared-weight passes, each item's image spliced at position 1
    (``begin``); CLS pair -> two-tower head."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = RobertaImageBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.classifier = TwoTowerClassificationHead(
                config.hidden_size, dropout_rate=config.hidden_dropout_prob,
                num_labels=config.num_labels)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids_1, image_embeds_1, input_ids_2,
                image_embeds_2, attention_mask_1=None, attention_mask_2=None,
                token_type_ids_1=None, token_type_ids_2=None, labels=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        out_1 = self.roberta(input_ids_1, (image_embeds_1, image_embeds_1),
                             attention_mask_1, token_type_ids_1,
                             deterministic=deterministic,
                             dropout_seed=fold_seed(dropout_seed, 0))[-1]
        out_2 = self.roberta(input_ids_2, (image_embeds_2, image_embeds_2),
                             attention_mask_2, token_type_ids_2,
                             deterministic=deterministic,
                             dropout_seed=fold_seed(dropout_seed, 1))[-1]
        return _two_tower_output(self, out_1, out_2, labels, deterministic,
                                 dropout_seed)


# --------------------------------------------------------- CoCa blocks
def rotary_freqs(n: int, dim: int, device=None) -> torch.Tensor:
    """[n, dim] rotary angles, fp32."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=device) / dim))
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device),
                        inv_freq)
    return torch.cat((freqs, freqs), dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t * pos.cos() + rotate_half(t) * pos.sin()


def swiglu(x: torch.Tensor) -> torch.Tensor:
    x, gate = x.chunk(2, dim=-1)
    return F.silu(gate) * x


def _ln(dim: int, dtype: Optional[torch.dtype] = None) -> LayerNorm:
    """flax's ``LayerNorm(use_bias=False)``: eps 1e-6."""
    return LayerNorm(dim, 1e-6, dtype, use_bias=False)


def _attend(q, k, v, mask_fill=None):
    """softmax(q kᵀ) v with one key/value head: q [B, h, N, dh], k and v
    [B, M, dh]; ``mask_fill(sim)`` masks the scores before the row max,
    which is held out of the gradient as JAX's ``stop_gradient`` does."""
    sim = _einsum("bhid,bjd->bhij", q, k)
    if mask_fill is not None:
        sim = mask_fill(sim)
    sim = sim - sim.amax(-1, keepdim=True).detach()
    return _einsum("bhij,bjd->bhid", torch.softmax(sim, dim=-1), v)


def _einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s type promotion (bf16 with fp32 gives fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(equation, a.to(dt), b.to(dt))


class ParallelTransformerBlock(nn.Module):
    """Fused attention + SwiGLU feed-forward block (PaLM style), returning
    ``attn_out(attention) + ff_out(swiglu(ff))``; the caller adds the
    residual."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, is_decoding: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.is_decoding = is_decoding
        attn_inner, ff_inner = heads * dim_head, dim * ff_mult
        self.splits = (attn_inner, dim_head, dim_head, 2 * ff_inner)
        self.norm = _ln(dim, dtype)
        self.fused_attn_ff_proj = Dense(dim, sum(self.splits), dtype,
                                        use_bias=False)
        self.attn_out = Dense(attn_inner, dim, dtype, use_bias=False)
        self.ff_out = Dense(ff_inner, dim, dtype, use_bias=False)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, _ = x.shape
        h, dh = self.heads, self.dim_head
        q, k, v, ff = self.fused_attn_ff_proj(self.norm(x)).split(
            self.splits, dim=-1)
        q = q.reshape(B, N, h, dh).transpose(1, 2)  # [B, h, N, dh]
        pos = rotary_freqs(N, dh, x.device)
        q = apply_rotary_pos_emb(pos, q) * (dh ** -0.5)
        k = apply_rotary_pos_emb(pos, k)  # [B, N, dh]: one kv head

        def mask_fill(sim):
            low = torch.finfo(sim.dtype).min
            if self.is_decoding:
                sim = sim.masked_fill(torch.ones(
                    N, N, dtype=torch.bool, device=sim.device).triu(1), low)
            if attn_mask is not None:
                sim = sim.masked_fill(~attn_mask[:, None].bool(), low)
            return sim

        out = _attend(q, k, v, mask_fill).transpose(1, 2).reshape(B, N, -1)
        return self.attn_out(out) + self.ff_out(swiglu(ff))


class CrossAttention(nn.Module):
    """Multi-query cross attention of the text on ``context`` (the image
    tokens), plus the parallel SwiGLU feed-forward when ``parallel_ff``;
    the caller adds the residual."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 parallel_ff: bool = False, ff_mult: int = 4,
                 norm_context: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = _ln(dim, dtype)
        self.context_norm = _ln(dim, dtype) if norm_context else None
        self.to_q = Dense(dim, inner, dtype, use_bias=False)
        self.to_kv = Dense(dim, 2 * dim_head, dtype, use_bias=False)
        self.to_out = Dense(inner, dim, dtype, use_bias=False)
        self.parallel_ff = parallel_ff
        if parallel_ff:
            self.ff_in = Dense(dim, 2 * dim * ff_mult, dtype, use_bias=False)
            self.ff_out = Dense(dim * ff_mult, dim, dtype, use_bias=False)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        h, dh = self.heads, self.dim_head
        y = self.norm(x)
        if self.context_norm is not None:
            context = self.context_norm(context)
        q = self.to_q(y).reshape(B, N, h, dh).transpose(1, 2) * (dh ** -0.5)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        out = _attend(q, k, v).transpose(1, 2).reshape(B, N, -1)
        out = self.to_out(out)
        if self.parallel_ff:
            out = out + self.ff_out(swiglu(self.ff_in(y)))
        return out


class MultimodalDecoder(nn.Module):
    """``multimodal_depth`` x (ParallelTransformerBlock + CrossAttention),
    each with its residual; bf16 inside under the bf16 policy, fp32 out."""

    def __init__(self, config: ModelConfig, is_decoding: bool = True):
        super().__init__()
        self.config = config
        self.dtype = torch.bfloat16 if config.dtype == "bfloat16" else None
        D, heads = config.hidden_size, config.coca_heads
        for i in range(config.multimodal_depth):
            self.add_module(f"attn_ff_{i}", ParallelTransformerBlock(
                D, D // heads, heads, config.ff_mult, is_decoding,
                self.dtype))
            self.add_module(f"cross_attn_{i}", CrossAttention(
                D, D // heads, heads, parallel_ff=True,
                ff_mult=config.ff_mult, dtype=self.dtype))

    def forward(self, text_tokens: torch.Tensor,
                image_tokens: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            text_tokens = text_tokens.to(self.dtype)
            image_tokens = image_tokens.to(self.dtype)
        for i in range(self.config.multimodal_depth):
            text_tokens = text_tokens + getattr(self, f"attn_ff_{i}")(
                text_tokens)
            text_tokens = text_tokens + getattr(self, f"cross_attn_{i}")(
                text_tokens, image_tokens)
        return text_tokens.float()


class CoCaModel(nn.Module):
    """Text encoder (``RobertaBackbone``) + image encoder (a ViT
    ``hidden_size`` wide, ``num_hidden_layers`` deep, with
    ``num_attention_heads`` heads) -> (text CLS, text tokens, image CLS,
    image tokens)."""

    def __init__(self, config: ModelConfig, device: torch.device):
        super().__init__()
        self.config = config
        self.text_encoder = RobertaBackbone(config, device, seed=None)
        with torch.device(device):
            self.img_encoder = ViT(
                image_size=config.image_size, patch_size=config.patch_size,
                dim=config.hidden_size, depth=config.num_hidden_layers,
                heads=config.num_attention_heads,
                mlp_ratio=config.intermediate_size / config.hidden_size)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, images=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        text_tokens = self.text_encoder(
            input_ids, attention_mask, token_type_ids, position_ids,
            deterministic=deterministic,
            dropout_seed=fold_seed(dropout_seed, 0))[-1]
        image_embeds = image_tokens = None
        if images is not None:
            image_embeds, image_tokens = self.img_encoder(
                images, deterministic, fold_seed(dropout_seed, 1))
        return text_tokens[:, 0], text_tokens, image_embeds, image_tokens


def _init_coca(model: nn.Module, device: torch.device,
               seed: Optional[int]) -> None:
    """Flax's initialisers over the text encoder, the ViT and the rest
    (tables normal(0.02), every config's ``initializer_range``)."""
    if seed is not None:
        init_image_weights(model, torch.Generator(device=device)
                           .manual_seed(seed))


class CoCaForPretraining(nn.Module):
    """Caption + contrastive pretraining; returns the loss.

    Without ``labels`` the labels are ``input_ids[:, 2:]`` and the inputs
    are cropped by one, so position t predicts token t + 2, as in the JAX
    package.  The caption logits are tied to the text encoder's word
    table; the caption loss is a cross-entropy that skips pad labels.  The
    contrastive loss is a symmetric InfoNCE of the text and image CLS
    vectors scaled by ``exp(temperature)`` (``temperature`` starts at 1)."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.coca = CoCaModel(config, dev)
        with torch.device(dev):
            self.multimodal = MultimodalDecoder(config, is_decoding=True)
            self.logits_norm = _ln(config.hidden_size)
            self.temperature = nn.Parameter(torch.ones(1))
        _init_coca(self, dev, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, images=None, labels=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        if labels is None:
            labels = input_ids[:, 2:]

            def crop(a):
                return None if a is None else a[:, :-1]

            input_ids, attention_mask, token_type_ids, position_ids = map(
                crop, (input_ids, attention_mask, token_type_ids,
                       position_ids))
        text_embeds, text_tokens, image_embeds, image_tokens = self.coca(
            input_ids, attention_mask, token_type_ids, position_ids, images,
            deterministic, dropout_seed)
        x = self.logits_norm(self.multimodal(text_tokens, image_tokens))
        table = self.coca.text_encoder.embeddings.word_embeddings.weight
        logits = x @ table.t()  # [B, N, V]

        T = labels.shape[1]
        logp = torch.log_softmax(logits[:, :T].float(), dim=-1)
        nll = -logp.gather(-1, labels[..., None].long())[..., 0]
        mask = (labels != cfg.pad_token_id).float()
        caption_loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
        caption_loss = caption_loss * cfg.caption_loss_weight

        sim = (text_embeds @ image_embeds.t()) * self.temperature.exp()
        target = torch.arange(sim.shape[0], device=sim.device)
        contrastive_loss = 0.5 * (cross_entropy_loss(sim, target)
                                  + cross_entropy_loss(sim.t(), target))
        return caption_loss + contrastive_loss * cfg.contrastive_loss_weight


class CoCaForItemAlignment(nn.Module):
    """Pair model over the CoCa towers: ``ensemble == "sum"`` adds each
    item's text and image CLS vectors; ``"cross_attn"`` runs the non-causal
    multimodal decoder (one, shared by the items) and takes token 0.  The
    ``vec_sim`` head, or the two-tower head with the embeds set to the two
    probability columns (the reference's quirk)."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.coca = CoCaModel(config, dev)
        with torch.device(dev):
            if config.ensemble == "cross_attn":
                self.multimodal = MultimodalDecoder(config, is_decoding=False)
            if config.classification_method == "vec_sim":
                self.classifier = VecSimClassificationHead(config)
            else:
                self.classifier = TwoTowerClassificationHead(
                    config.hidden_size,
                    dropout_rate=config.hidden_dropout_prob,
                    num_labels=config.num_labels)
        _init_coca(self, dev, seed)

    def forward(self, input_ids_1, images_1, input_ids_2, images_2,
                attention_mask_1=None, attention_mask_2=None,
                token_type_ids_1=None, token_type_ids_2=None, labels=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        cfg = self.config
        te1, tt1, ie1, it1 = self.coca(
            input_ids_1, attention_mask_1, token_type_ids_1, images=images_1,
            deterministic=deterministic,
            dropout_seed=fold_seed(dropout_seed, 0))
        te2, tt2, ie2, it2 = self.coca(
            input_ids_2, attention_mask_2, token_type_ids_2, images=images_2,
            deterministic=deterministic,
            dropout_seed=fold_seed(dropout_seed, 1))
        if cfg.ensemble == "cross_attn":
            embeds_1 = self.multimodal(tt1, it1)[:, 0]
            embeds_2 = self.multimodal(tt2, it2)[:, 0]
        else:  # "sum"
            embeds_1, embeds_2 = te1 + ie1, te2 + ie2
        head_seed = fold_seed(dropout_seed, 2)
        if cfg.classification_method == "vec_sim":
            src_embeds, tgt_embeds, logits, probs = self.classifier(
                embeds_1, embeds_2, deterministic, head_seed)
        else:
            _, _, logits, full_probs = self.classifier(
                embeds_1, embeds_2, deterministic, head_seed)
            src_embeds = full_probs[:, 0]
            tgt_embeds = full_probs[:, 1]
            probs = full_probs[:, 1]
        loss = None
        if labels is not None:
            loss = pair_loss(cfg.loss_type, logits, probs, labels,
                             src_embeds, tgt_embeds, cfg.loss_margin,
                             cfg.num_labels)
        return PairClassifierOutput(loss=loss, logits=logits, probs=probs,
                                    src_embeds=src_embeds,
                                    tgt_embeds=tgt_embeds)
