"""Configuration, a copy of ``item_alignment_tpu.config``: ``ModelConfig``,
``MeshConfig``, ``OptimizerConfig`` and ``TrainConfig``.

The port keeps its own copy so that it never imports the JAX package.  Every
field, default, property and preset is the same as there (a test holds the
two equal), so that configs and checkpoints move between the packages
unchanged.  The port does not read ``gcn_edge_chunk`` and
``gcn_sorted_edges`` (its ``ops/sparse.Adjacency`` holds the chunk and sees
the order itself) nor ``gcn_scan_layers`` (its GCNII always stacks the
layers' kernels; ``convert.py`` reads both Flax trees); neither package
reads ``dim_head``.
In the port's ``Trainer``, ``TrainConfig.scan_steps`` groups an epoch's
steps into chunks whose batches go to the device together and at whose
ends the loss is logged and evaluations run, as in the JAX ``Trainer``
(each step still runs eagerly); ``dropout_rng_impl`` has no effect (the
dropout masks are hashes of integer seeds), and a mesh of more than one
device needs a process of its own for each device (``parallel/mesh.py``).

- ``interaction_type``:       one_tower | two_tower
- ``classification_method``:  cls | vec_sim
- ``similarity_measure``:     softmax | inner_product | cosine | l1 | l2
- ``loss_type``:              ce | bce | cosine | hinge | euclidean
- ``ensemble`` (multimodal):  begin | end | sum | cross_attn
- ``cls_layers`` / ``cls_pool``: which hidden states feed the head and how
  they are combined.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Flat model config.  Defaults correspond to chinese-roberta-wwm-ext
    *base* with the CCKS2022 flag set."""

    model_name: str = "roberta"

    # --- transformer encoder ---
    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 4  # vec_sim uses token_type+1 on the tgt side
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    classifier_dropout: Optional[float] = None
    num_labels: int = 2
    cate_size: Optional[int] = None  # category-embedding hook

    # --- pair-classification knobs ---
    interaction_type: str = "one_tower"       # one_tower | two_tower
    classification_method: str = "cls"        # cls | vec_sim
    similarity_measure: str = "softmax"       # softmax|inner_product|cosine|l1|l2
    loss_type: str = "ce"                     # ce|bce|cosine|hinge|euclidean
    loss_margin: float = 0.0
    cls_layers: Tuple[int, ...] = (1,)        # 1 = last layer, 2 = second-to-last…
    cls_pool: str = "cat"                     # cat | avg
    auxiliary_task: bool = False
    max_pair_indices: int = 32                # static-size aux-task pair budget

    # --- sequence layout ---
    max_seq_len: Optional[int] = 50           # title tokens
    max_seq_len_pv: Optional[int] = 205       # pv tokens

    # --- PKGM (knowledge-graph) extension ---
    num_entities: int = 0
    num_relations: int = 0
    kg_embedding_dim: int = 768
    max_pvs: int = 30
    entity_projection_bias: bool = False
    kg_entity_normalize: str = "reference"    # reference | l2

    # --- multimodal extension ---
    ensemble: Optional[str] = None            # begin | end | sum | cross_attn
    image_hidden_size: int = 3072

    # --- TextCNN ---
    filter_sizes: Tuple[int, ...] = (1, 2, 3, 5)
    num_filters: int = 128

    # --- image towers ---
    image_model_name: str = "vit_base_patch16_384"
    image_size: int = 384
    patch_size: int = 16

    # --- CoCa ---
    multimodal_depth: int = 12
    dim_head: int = 64
    coca_heads: int = 8
    ff_mult: int = 4
    caption_loss_weight: float = 1.0
    contrastive_loss_weight: float = 1.0

    # --- GCN ---
    gcn_hidden: int = 128
    gcn_layers: int = 4
    gcn_alpha: float = 0.1
    gcn_theta: float = 0.5
    gcn_feature_dim: int = 1024
    gcn_edge_chunk: Optional[int] = None      # edge-list chunk size
    gcn_sorted_edges: bool = False            # edge list pre-sorted by dst
    gcn_scan_layers: bool = False             # stacked layer params

    # --- numerics ---
    dtype: str = "float32"                    # compute dtype: float32|bfloat16
    use_flash_attention: bool = True          # fused attention kernel
    remat: bool = False                       # recompute encoder layers in
                                              # the backward (training)
    remat_policy: str = "dots"                # full | dots | mlp
    quant: Optional[str] = None               # None | "int8" dense projections
    fuse_qkv: bool = False                    # one [H, 3H] q/k/v product per
                                              # layer; parameters stay separate

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def pair_seq_len(self) -> int:
        """Total one-tower sequence length: 2 * per-item length."""
        return 2 * self.item_seq_len

    @property
    def item_seq_len(self) -> int:
        if self.max_seq_len is None:
            return int(self.max_seq_len_pv)
        if self.max_seq_len_pv is None:
            return int(self.max_seq_len)
        return int(self.max_seq_len) + int(self.max_seq_len_pv)

    @property
    def num_cls_features(self) -> int:
        length = 1 if self.cls_pool == "avg" else len(self.cls_layers)
        return self.hidden_size * length

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- presets -------------------------------------------------------
    @classmethod
    def roberta_base(cls, **kw: Any) -> "ModelConfig":
        return cls(**kw)

    @classmethod
    def roberta_large(cls, **kw: Any) -> "ModelConfig":
        base = dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def pkgm_base(cls, **kw: Any) -> "ModelConfig":
        base = dict(
            model_name="pkgm", num_entities=258211, num_relations=1379,
            kg_embedding_dim=768, max_seq_len=64, max_seq_len_pv=None,
            max_pvs=30,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def pkgm_large(cls, **kw: Any) -> "ModelConfig":
        base = dict(
            model_name="pkgm", hidden_size=1024, num_hidden_layers=24,
            num_attention_heads=16, intermediate_size=4096,
            num_entities=258211, num_relations=1379, kg_embedding_dim=1024,
            max_seq_len=64, max_seq_len_pv=None, max_pvs=30,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def roberta_image_large(cls, **kw: Any) -> "ModelConfig":
        base = dict(
            model_name="roberta_image", hidden_size=1024,
            num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, ensemble="begin", image_hidden_size=3072,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def textcnn(cls, **kw: Any) -> "ModelConfig":
        base = dict(model_name="textcnn", interaction_type="two_tower")
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_json(cls, path: str, **overrides: Any) -> "ModelConfig":
        """Load a reference-style JSON config, ignoring unknown keys."""
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in known}
        for key in ("cls_layers", "filter_sizes"):
            if isinstance(kw.get(key), str):
                kw[key] = tuple(int(i) for i in kw[key].split(","))
        kw.update(overrides)
        return cls(**kw)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: data (DP), fsdp (ZeRO-style), tensor (TP)."""

    data: int = -1      # -1: use all remaining devices
    fsdp: int = 1
    tensor: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int, int]:
        fsdp, tensor = max(self.fsdp, 1), max(self.tensor, 1)
        data = self.data
        if data == -1:
            if n_devices % (fsdp * tensor):
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fsdp={fsdp}*tensor={tensor}")
            data = n_devices // (fsdp * tensor)
        if data * fsdp * tensor != n_devices:
            raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n_devices} "
                             "devices")
        return data, fsdp, tensor


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + linear warmup/decay: no weight decay on biases and LayerNorm,
    betas (0.9, 0.98)."""

    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-8
    warmup_proportion: float = 0.1
    total_steps: int = 10000
    grad_accumulation_steps: int = 1
    max_grad_norm: Optional[float] = None
    # substring patterns matched against the '/'-joined Flax parameter path;
    # matching parameters receive zero updates
    freeze_patterns: Tuple[str, ...] = ()
    # the JAX package's single-pass AdamW; the port always takes one pass
    # per tensor, and False only keeps the moments in float32
    fused: bool = True
    # storage dtype of the fused optimizer's moments ("float32" |
    # "bfloat16"); their arithmetic stays fp32
    state_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 2345
    train_batch_size: int = 32
    eval_batch_size: int = 64
    num_epochs: int = 10
    log_steps: int = 100
    output_dir: str = "output"
    threshold: float = 0.5
    eval_thresholds: Tuple[float, ...] = tuple(round(0.1 * i, 1) for i in range(1, 10))
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 20
    checkpoint_dir: Optional[str] = None     # full-train-state checkpoints
    resume: bool = False                     # restore the latest before fit
    eval_every_steps: Optional[int] = None   # step-based eval
    early_stopping_patience: Optional[int] = None  # evals without F1 gain
    dropout_rng_impl: str = "rbg"            # no effect in the port
    scan_steps: int = 8                      # steps a chunk: one batch
                                             # transfer, loss logged at ends
    mesh: MeshConfig = field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
