from .dispatch import DecodePlan, decode, resolve_plan  # noqa: F401
from .epilogues import EPILOGUES, apply_grid, fused_decode  # noqa: F401
from .ops import (  # noqa: F401
    normalize_block_meta,
    normalize_probe,
    vbyte_decode_blocked,
)
from .ref import vbyte_decode_blocked_ref  # noqa: F401
