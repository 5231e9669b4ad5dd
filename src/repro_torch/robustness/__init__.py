"""Hardened decode: stream validation, fault injection, degraded serving.

The port of ``repro/robustness``:

* :mod:`repro_torch.robustness.validate` — the error taxonomy (typed
  :class:`DecodeError` subclasses carrying block/term coordinates), host
  stream/metadata validators for the three formats, and checksum-verified
  decode (:func:`decode_checked`) through kernel 2's ``checksum``
  epilogue.
* :mod:`repro_torch.robustness.faultgen` — the seeded corruption generator
  behind the detect-or-defined-value tests.
* :mod:`repro_torch.robustness.atomic_io` — the crash-consistent write
  protocol (tmp + fsync + rename) for everything that persists state.
* degraded-mode serving lives with the engine in
  ``repro_torch.launch.serve`` (quarantine, deadlines, retry, shard loss),
  built on these validators.
"""
from .atomic_io import (  # noqa: F401
    atomic_write_bytes,
    atomic_write_dir,
    atomic_write_json,
    clean_tmp,
    crc32_file,
    fsync_dir,
)
from .validate import (  # noqa: F401
    BlockMetaError,
    BoundViolationError,
    CheckpointError,
    ChecksumError,
    ControlMismatchError,
    Deadline,
    DecodeError,
    NonCanonicalError,
    OverlongRunError,
    SegmentError,
    TruncatedPayloadError,
    WalError,
    decode_checked,
    validate_array,
    validate_meta,
    validate_stream,
    validate_structure,
)
