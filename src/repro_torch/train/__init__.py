"""Training: AdamW with clipping and a warm-up cosine schedule, int8
gradient compression with error feedback (and ``compressed_psum``, its
collective over a mesh axis), and the train step, with the reference's
ZeRO-1 hooks (``compute_cast``, ``grad_transform``) and
``jit_train_step``, which runs a step data-parallel over a mesh from one
controller (``train_state.py``). The port of ``repro/train``.
"""
from . import grad_compress, optimizer, train_state  # noqa: F401
from .optimizer import OptimizerConfig  # noqa: F401
from .train_state import (ShardedParams, init_train_state,  # noqa: F401
                          jit_train_step, make_train_step, map_params,
                          param_leaves)
