"""Carry state across from the JAX package: compressed arrays, the
compressed index, the LM, recsys and GIN parameters, and their train
states.

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


def _layernorm(tree: dict, dev):
    from repro_torch.nn.layers import LayerNorm

    return LayerNorm(_tensor(tree["scale"], dev), _tensor(tree["bias"], dev))


def recsys_params_from_numpy(params: dict, cfg, device=None):
    """The port's recsys parameters from the reference's tree as numpy
    arrays. Two-tower (a :class:`~repro_torch.models.recsys.TwoTower`):
    ``user_emb/emb``, ``item_id_emb/emb``, ``user_mlp/layer_i/{w,b}``,
    ``item_mlp/...``. SASRec, BERT4Rec, BST (a
    :class:`~repro_torch.models.recsys.SeqRec`): ``item_emb/emb``,
    ``pos_emb/emb``, ``blocks/block_i/{ln1/{scale,bias},
    attn/{wq,wk,wv,wo}/w, ln2/..., ffn/{w1,w2}/{w,b}}``, ``final_ln/...``
    and, for BST, ``mlp/layer_i/{w,b}``."""
    from repro_torch.models.recsys import Block, SeqRec, TwoTower

    dev = resolve_device(device)
    if cfg.kind == "two_tower":
        return TwoTower(_tensor(params["user_emb"]["emb"], dev),
                        _tensor(params["item_id_emb"]["emb"], dev),
                        _mlp(params["user_mlp"], dev),
                        _mlp(params["item_mlp"], dev))
    blocks = []
    for i in range(cfg.n_blocks):
        b = params["blocks"][f"block_{i}"]
        a, f = b["attn"], b["ffn"]
        blocks.append(Block(
            _layernorm(b["ln1"], dev),
            *(_tensor(a[k]["w"], dev) for k in ("wq", "wk", "wv", "wo")),
            _layernorm(b["ln2"], dev),
            _tensor(f["w1"]["w"], dev), _tensor(f["w1"]["b"], dev),
            _tensor(f["w2"]["w"], dev), _tensor(f["w2"]["b"], dev)))
    return SeqRec(_tensor(params["item_emb"]["emb"], dev),
                  _tensor(params["pos_emb"]["emb"], dev), blocks,
                  _layernorm(params["final_ln"], dev),
                  _mlp(params["mlp"], dev) if "mlp" in params else None)


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


def lm_params_from_numpy(params: dict, cfg, device=None):
    """The port's :class:`~repro_torch.models.lm.LM` from the reference's
    LM tree as numpy arrays, its layers stacked on a leading ``L`` axis
    as there: ``embed/emb``, ``layers/{attn_norm/scale,
    attn/{wq,wk,wv,wo}/w, ffn_norm/scale}`` with ``layers/ffn/{gate,up,
    down}/w`` (dense) or ``layers/moe/{router,gate,up,down}/w`` (MoE),
    ``final_norm/scale`` and ``lm_head/w``."""
    from repro_torch.models.lm import LM, Layers
    from repro_torch.nn.layers import RMSNorm, SwiGLU
    from repro_torch.nn.moe import MoE

    dev = resolve_device(device)
    lp = params["layers"]

    def w(tree, *keys):
        return tuple(_tensor(tree[k]["w"], dev) for k in keys)

    ffn = moe = None
    if cfg.moe:
        moe = MoE(*w(lp["moe"], "router", "gate", "up", "down"))
    else:
        ffn = SwiGLU(*w(lp["ffn"], "gate", "up", "down"))
    layers = Layers(RMSNorm(_tensor(lp["attn_norm"]["scale"], dev)),
                    *w(lp["attn"], "wq", "wk", "wv", "wo"),
                    RMSNorm(_tensor(lp["ffn_norm"]["scale"], dev)), ffn, moe)
    return LM(_tensor(params["embed"]["emb"], dev), layers,
              RMSNorm(_tensor(params["final_norm"]["scale"], dev)),
              _tensor(params["lm_head"]["w"], dev))


def train_state_tree(state: dict, *, whole: bool = True) -> dict:
    """A train state (``repro_torch.train.init_train_state``) as the
    reference's train-state tree: ``params`` (the model's ``tree()``),
    ``opt/m`` and ``opt/v`` under the same paths, ``opt/step`` and, where
    the run compresses gradients, ``ef``. Its leaves are the state's own
    tensors; ``repro_torch.checkpoint.CheckpointManager`` writes them in
    the reference's leaf order and under its paths, so either package
    restores the other's checkpoint directory. A state placed on a mesh
    (``train.jit_train_step``) gives each leaf whole (gathered), or as
    placed with ``whole=False``."""
    from repro_torch.distributed.sharding import whole as whole_leaf
    from repro_torch.tree import flatten, nest, unflatten_like

    opt = state["opt"]
    tree = {"params": state["params"].tree(),
            "opt": {"m": nest(opt["m"]), "v": nest(opt["v"]),
                    "step": opt["step"]}}
    if "ef" in state:
        tree["ef"] = nest(state["ef"])
    if not whole:
        return tree
    return unflatten_like(tree, [whole_leaf(x) for _, x in flatten(tree)])


def train_state_from_tree(tree: dict, params_from_numpy, cfg,
                          device=None) -> dict:
    """The port's train state from the reference's train-state tree (numpy
    arrays or tensors, as a checkpoint restores them), on ``device``
    (default: the card); the parameters, built by
    ``params_from_numpy(tree["params"], cfg, device)``, require grad."""
    from repro_torch.train import param_leaves
    from repro_torch.tree import flatten

    dev = resolve_device(device)
    params = params_from_numpy(tree["params"], cfg, device=dev)
    for p in param_leaves(params).values():
        p.requires_grad_(True)

    def leaves(t):
        return {k: _tensor(v, dev) for k, v in flatten(t)}

    opt = tree["opt"]
    state = {"params": params,
             "opt": {"m": leaves(opt["m"]), "v": leaves(opt["v"]),
                     "step": torch.tensor(np.asarray(opt["step"]),
                                          dtype=torch.int32, device=dev)}}
    if tree.get("ef") is not None:
        state["ef"] = leaves(tree["ef"])
    return state


def gnn_train_state_from_tree(tree: dict, cfg, device=None) -> dict:
    """The port's GIN train state from the reference's train-state tree."""
    return train_state_from_tree(tree, gnn_params_from_numpy, cfg, device)


def recsys_train_state_from_tree(tree: dict, cfg, device=None) -> dict:
    """The port's recsys train state (any kind) from the reference's
    train-state tree."""
    return train_state_from_tree(tree, recsys_params_from_numpy, cfg, device)


def lm_train_state_from_tree(tree: dict, cfg, device=None) -> dict:
    """The port's LM train state from the reference's train-state tree."""
    return train_state_from_tree(tree, lm_params_from_numpy, cfg, device)
