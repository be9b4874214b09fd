"""Parallelism layer: meshes of ranks, placement rules and the shards.

Counterpart of ``quantizers_tpu/parallel``. The JAX package scales through
``jax.sharding``: a named mesh and PartitionSpec rules, with XLA inserting
the collectives. The port runs one process per device over
``torch.distributed``: a named mesh of ranks (``dp`` over batches, ``tp``
over heads and features, ``ep`` over experts, ``cp`` over the sequence),
the same placement rules, shards cut explicitly for each rank, and the few
collectives of :mod:`.collectives` where the rules need them.
"""

from .distributed import (  # noqa: F401
    initialize,
    make_pod_mesh,
    parse_mesh_arg,
)
from .ring import ring_attention  # noqa: F401
from .mesh import (  # noqa: F401
    make_mesh,
    shard_params,
    param_pspecs,
    activation_pspec,
    kv_cache_pspecs,
)
