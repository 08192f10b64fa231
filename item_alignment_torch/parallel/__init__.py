"""Parallelism: the device mesh and the sharding rules (one process per
device; ``mesh.py``, ``sharding.py``; ``dryrun.py`` drives one sharded step
of each model family)."""

from item_alignment_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    initialize_distributed,
    maybe_initialize_distributed_from_args,
)
from item_alignment_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_partition_spec,
    shard_params,
    tree_shardings,
)
