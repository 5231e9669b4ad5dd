"""PyTorch + CUDA port of the compressed-index search stack.

A second package beside the JAX reference (``repro``): the same blocked
VByte encoding, decode and query paths, running on an NVIDIA Hopper card
through hand-written CUDA kernels (``kernels/vbyte_decode/csrc``). Modules
mirror the reference's layout, so each one's counterpart is found by
path. The package imports torch and numpy only — never jax, never
``repro``. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from ._device import resolve_device  # noqa: F401
