"""Carry state across from the JAX package: the compressed index.

This system has no weights; its state is the compressed inverted index.
These functions build the port's objects from plain numpy leaves, so an
index built by the reference (or saved from it) serves on the card with
identical bytes. The port never imports the reference: the caller hands
over numpy arrays and integers.
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.compressed_array import CompressedIntArray
from repro_torch.index.builder import InvertedIndex, TermPostings


def compressed_from_numpy(leaves: dict, *, format: str, block_size: int,
                          differential: bool, n: int,
                          payload_bytes: int | None, device=None,
                          ragged: bool = False,
                          checksums=None) -> CompressedIntArray:
    """A ``CompressedIntArray`` from the numpy leaves of its format —
    ``payload`` (vbyte), ``control`` + ``data`` (streamvbyte) or
    ``widths`` + ``data`` (binpack), each uint8 ``[n_blocks, …]`` — plus
    ``counts`` (``[n_blocks]``) and ``bases`` (uint32 ``[n_blocks]``).
    ``payload_bytes`` is the tight encoded size (the reference's
    ``host_enc.payload_bytes``), kept for ``bits_per_int``."""
    return CompressedIntArray.from_operands(
        leaves, format=format, block_size=block_size,
        differential=differential, n=n, payload_bytes=payload_bytes,
        ragged=ragged, checksums=checksums, device=device)


def index_from_numpy(terms: dict, *, n_docs: int, block_size: int,
                     format: str, impact_bits: int, has_tf: bool,
                     device=None) -> InvertedIndex:
    """An ``InvertedIndex`` from per-term numpy state.

    ``terms[t]`` is a dict with ``df``, ``first_doc``, ``last_doc``,
    ``max_impact`` and two stream dicts, ``arr`` (the d-gap docid stream)
    and ``impacts``, each holding the leaves of :func:`compressed_from_numpy`
    plus ``n`` and ``payload_bytes``. A stream dict may name its own
    ``format``: an index built with ``format="auto"`` picks the codec per
    term, so its streams do; otherwise the index's ``format`` applies.
    """
    dev = resolve_device(device)

    def stream(s: dict, differential: bool) -> CompressedIntArray:
        return compressed_from_numpy(
            s, format=s.get("format", format), block_size=block_size,
            differential=differential, n=s["n"],
            payload_bytes=s.get("payload_bytes"),
            checksums=s.get("checksums"), device=dev)

    index = InvertedIndex(terms={}, n_docs=int(n_docs), block_size=block_size,
                          format=format, impact_bits=impact_bits,
                          has_tf=has_tf)
    for t, st in terms.items():
        index.terms[t] = TermPostings(
            term=t, arr=stream(st["arr"], True),
            first_doc=np.asarray(st["first_doc"], np.uint32),
            last_doc=np.asarray(st["last_doc"], np.uint32),
            df=int(st["df"]),
            impacts=(stream(st["impacts"], False)
                     if st.get("impacts") is not None else None),
            max_impact=np.asarray(st["max_impact"], np.int32))
    return index
