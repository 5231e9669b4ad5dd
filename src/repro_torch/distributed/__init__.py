"""Single-controller sharding over a mesh of devices (see ``api.py``)."""
from .api import (  # noqa: F401
    Mesh,
    activate_mesh,
    current_mesh,
    make_mesh,
)
from .sharding import (  # noqa: F401
    BlockSharded,
    Replicated,
    compressed_block_specs,
    replicate,
    shard_compressed,
)
