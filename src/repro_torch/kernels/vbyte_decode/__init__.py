from .dispatch import DecodePlan, decode, resolve_plan  # noqa: F401
from .epilogues import EPILOGUES, apply_grid, fused_decode  # noqa: F401
from .ops import (  # noqa: F401
    binpack_decode_blocked,
    normalize_block_meta,
    normalize_probe,
    stream_vbyte_decode_blocked,
    vbyte_decode_blocked,
)
from .ref import vbyte_decode_blocked_ref  # noqa: F401
