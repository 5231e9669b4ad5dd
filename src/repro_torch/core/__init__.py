from . import vbyte  # noqa: F401
from .compressed_array import CompressedIntArray  # noqa: F401
