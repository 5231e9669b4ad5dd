"""Carry state across from the JAX package: compressed arrays, the
compressed index, and the two-tower and GIN parameters.

These functions build the port's objects from plain numpy leaves, so an
index built by the reference (or saved from it) serves on the card with
identical bytes, and a model initialised by the reference computes the
same thing in the port. The port never imports the reference: the caller
hands over numpy arrays, nested dicts of them with the reference's key
names, and integers.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)


def _mlp(tree: dict, dev):
    from repro_torch.nn.layers import MLP

    return MLP([(_tensor(tree[f"layer_{i}"]["w"], dev),
                 _tensor(tree[f"layer_{i}"]["b"], dev))
                for i in range(len(tree))])


def recsys_params_from_numpy(params: dict, cfg, device=None):
    """The port's :class:`~repro_torch.models.recsys.TwoTower` from the
    reference's two-tower parameter tree as numpy arrays: ``user_emb/emb``,
    ``item_id_emb/emb``, ``user_mlp/layer_i/{w,b}``, ``item_mlp/...``."""
    from repro_torch.models.recsys import TwoTower

    if cfg.kind != "two_tower":
        raise NotImplementedError(f"recsys kind {cfg.kind!r} is not ported "
                                  "yet (ROADMAP queue 1 item 14)")
    dev = resolve_device(device)
    return TwoTower(_tensor(params["user_emb"]["emb"], dev),
                    _tensor(params["item_id_emb"]["emb"], dev),
                    _mlp(params["user_mlp"], dev),
                    _mlp(params["item_mlp"], dev))


def gnn_params_from_numpy(params: dict, cfg, device=None):
    """The port's :class:`~repro_torch.models.gnn.GIN` from the reference's
    GIN parameter tree as numpy arrays:
    ``layers/gin_i/{eps, mlp1/w, b1, mlp2/w, b2}`` and ``head/{w, b}``."""
    from repro_torch.models.gnn import GIN
    from repro_torch.nn.gnn import GINLayer

    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        lp = params["layers"][f"gin_{i}"]
        layers.append(GINLayer(_tensor(lp["eps"], dev),
                               _tensor(lp["mlp1"]["w"], dev),
                               _tensor(lp["b1"], dev),
                               _tensor(lp["mlp2"]["w"], dev),
                               _tensor(lp["b2"], dev)))
    return GIN(layers, _tensor(params["head"]["w"], dev),
               _tensor(params["head"]["b"], dev))
