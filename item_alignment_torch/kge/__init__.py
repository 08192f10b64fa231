"""Knowledge-graph embeddings: the port of ``item_alignment_tpu/kge``."""

from item_alignment_torch.kge.graph import KnowledgeGraph, load_ccks  # noqa: F401
from item_alignment_torch.kge.models import KGEModel, make_kge_model  # noqa: F401
from item_alignment_torch.kge.sampling import (  # noqa: F401
    BernoulliNegativeSampler,
    PositionalNegativeSampler,
    UniformNegativeSampler,
)
from item_alignment_torch.kge.inference import (  # noqa: F401
    EntityInference,
    RelationInference,
)
from item_alignment_torch.kge.train import KGETrainer  # noqa: F401
from item_alignment_torch.kge.evaluation import LinkPredictionEvaluator  # noqa: F401
