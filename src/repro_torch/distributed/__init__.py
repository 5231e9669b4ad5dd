"""Single-controller sharding over a mesh of devices (see ``api.py``)."""
from .api import (  # noqa: F401
    Mesh,
    NamedSharding,
    activate_mesh,
    constrain,
    current_mesh,
    make_mesh,
    named_sharding,
)
from .sharding import (  # noqa: F401
    BlockSharded,
    Replicated,
    compressed_array_specs,
    compressed_block_specs,
    gnn_param_spec,
    lm_cache_spec,
    lm_param_spec,
    place,
    recsys_param_spec,
    replicate,
    shard_compressed,
    state_specs,
    to_named,
    tree_specs,
    zero1_extend,
)
