from . import (  # noqa: F401
    binpack,
    binpack_masked,
    device_encode,
    encode,
    masked,
    ref,
    stream_masked,
    stream_vbyte,
)
from .binpack import (  # noqa: F401
    BinpackEncoding,
    bit_widths,
)
from .encode import (  # noqa: F401
    BlockedEncoding,
    BlockedMeta,
    delta_decode,
    delta_encode,
    encode_blocked,
    encode_ragged_blocked,
    encode_stream,
    prepare_blocked,
    validate_u32,
    vbyte_lengths,
)
from .stream_vbyte import (  # noqa: F401
    StreamVByteEncoding,
    svb_lengths,
)
