from . import encode, masked, ref  # noqa: F401
from .encode import (  # noqa: F401
    BlockedEncoding,
    BlockedMeta,
    delta_encode,
    encode_blocked,
    encode_ragged_blocked,
    encode_stream,
    prepare_blocked,
    validate_u32,
    vbyte_lengths,
)
