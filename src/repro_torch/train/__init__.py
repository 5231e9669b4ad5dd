"""Training: AdamW with clipping and a warm-up cosine schedule, int8
gradient compression with error feedback, and the train step.

The port of ``repro/train`` for one card. The reference's ZeRO and
sharding hooks (``make_train_step``'s ``compute_cast`` and
``grad_transform``, ``jit_train_step``) and ``compressed_psum`` (a
``shard_map`` collective) wait for the sharded stack (ROADMAP queue 1
item 13).
"""
from . import grad_compress, optimizer, train_state  # noqa: F401
from .optimizer import OptimizerConfig  # noqa: F401
from .train_state import (init_train_state, make_train_step,  # noqa: F401
                          param_leaves)
