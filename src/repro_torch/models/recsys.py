"""RecSys family: SASRec, BERT4Rec, BST and two-tower retrieval.

The port of ``repro/models/recsys.py``: ``RecSysConfig``, the shared
pre-LN sequence encoder (``_block_init``, ``_encode_seq``, ``_seq_repr``,
``_item_scores``), ``init_params`` for every kind, the losses
(``loss_fn``), ``bst_forward``, the two-tower towers, ``serve_scores``
and ``retrieval_scores_compressed``. Parameters live in modules
(:class:`SeqRec`, :class:`TwoTower`) whose ``tree()`` gives them under
the reference's paths; the functions keep the reference's signatures.
The reference's ``constrain(...)`` calls place activations on its mesh;
over the port's mesh each replica already holds its own rows
(``distributed/api.py``), so they are not carried over. Pad id 0 attends like any other id, as in
the reference (no key-padding mask).

Two ways of computing the same function keep a batch of 65,536 whole on
one card, and ``loss_fn`` picks them from the batch's size
(:func:`train_options`): block recomputation (the sequence kinds: each
encoder block recomputed in the backward pass, ``torch.utils.checkpoint``)
and the two-tower in-batch softmax in row chunks (each chunk's ``[c, B]``
logits recomputed in the backward pass, so the ``[B, B]`` float32 logits
never exist at once).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn.embedding_bag import bag_from_padded
from repro_torch.nn.layers import accum_matmul

@dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str  # "sasrec" | "bert4rec" | "bst" | "two_tower"
    n_items: int
    embed_dim: int
    seq_len: int
    n_blocks: int = 2
    n_heads: int = 1
    mlp_dims: tuple[int, ...] = ()
    n_users: int = 0  # two-tower
    id_dim: int = 128  # two-tower id embedding width
    n_mask: int = 0  # bert4rec masked positions per sequence
    n_negatives: int = 1024  # sampled-softmax shared negatives
    serve_candidates: int = 4096
    # serving-time embedding-table layout of the reference's mesh engine:
    # "row" | "replicated" | "column" (one device here: unused)
    serve_table_mode: str = "row"
    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def vocab_rows(self) -> int:
        # +2: padding id 0 is reserved, bert4rec adds a [MASK] row at the end;
        # rounded to a multiple of 512 (the reference row-shards the table)
        return -(-(self.n_items + 2) // 512) * 512

    @property
    def user_rows(self) -> int:
        return -(-(self.n_users + 2) // 512) * 512

    def param_count(self) -> int:
        d = self.embed_dim
        if self.kind == "two_tower":
            n = self.user_rows * self.id_dim + self.vocab_rows * self.id_dim
            dims_u = (self.id_dim * 2,) + self.mlp_dims
            dims_i = (self.id_dim,) + self.mlp_dims
            n += sum(a * b + b for a, b in zip(dims_u[:-1], dims_u[1:]))
            n += sum(a * b + b for a, b in zip(dims_i[:-1], dims_i[1:]))
            return n
        n = self.vocab_rows * d + (self.seq_len + 1) * d
        per_block = 4 * d * d + 2 * (d * d + d) + 4 * d  # attn + pw-ffn + norms
        n += self.n_blocks * per_block
        if self.kind == "bst":
            dims = ((self.seq_len + 1) * d,) + self.mlp_dims + (1,)
            n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n

    def dense_flops_per_example(self) -> int:
        """Approx fwd FLOPs per scored example."""
        d = self.embed_dim
        if self.kind == "two_tower":
            dims_u = (self.id_dim * 2,) + self.mlp_dims
            dims_i = (self.id_dim,) + self.mlp_dims
            mm = sum(a * b for a, b in zip(dims_u[:-1], dims_u[1:]))
            mm += sum(a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
            return 2 * mm
        L = self.seq_len + (1 if self.kind == "bst" else 0)
        per_block = 2 * L * (6 * d * d) + 2 * 2 * L * L * d  # proj+ffn, qk+pv
        n = self.n_blocks * per_block
        if self.kind == "bst":
            dims = (L * d,) + self.mlp_dims + (1,)
            n += 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        return n


class TwoTower(nn.Module):
    """Two-tower parameters: id embeddings (float32 ``[rows, id_dim]``) and
    the user and item MLP towers. The user tower reads the user's id
    embedding and the mean of its history's item-id embeddings."""

    def __init__(self, user_emb: torch.Tensor, item_id_emb: torch.Tensor,
                 user_mlp: nnl.MLP, item_mlp: nnl.MLP):
        super().__init__()
        self.user_emb = nnl._param(user_emb)
        self.item_id_emb = nnl._param(item_id_emb)
        self.user_mlp = user_mlp
        self.item_mlp = item_mlp

    def tree(self) -> dict:
        return {"user_emb": {"emb": self.user_emb},
                "item_id_emb": {"emb": self.item_id_emb},
                "user_mlp": self.user_mlp.tree(),
                "item_mlp": self.item_mlp.tree()}


class Block(nn.Module):
    """One pre-LN transformer block: ``ln1``, attention projections
    ``wq, wk, wv, wo [d, d]``, ``ln2`` and the position-wise FFN ``w1, w2
    [d, d]`` with biases ``b1, b2 [d]``; float32."""

    def __init__(self, ln1: nnl.LayerNorm, wq, wk, wv, wo,
                 ln2: nnl.LayerNorm, w1, b1, w2, b2):
        super().__init__()
        self.ln1, self.ln2 = ln1, ln2
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
            setattr(self, name, nnl._param(t))

    def tree(self) -> dict:
        return {"ln1": self.ln1.tree(),
                "attn": {k: {"w": getattr(self, k)}
                         for k in ("wq", "wk", "wv", "wo")},
                "ln2": self.ln2.tree(),
                "ffn": {"w1": {"w": self.w1, "b": self.b1},
                        "w2": {"w": self.w2, "b": self.b2}}}


class SeqRec(nn.Module):
    """SASRec / BERT4Rec / BST parameters: ``item_emb [vocab_rows, d]``,
    ``pos_emb [seq_len + 1, d]``, the encoder blocks, ``final_ln`` and,
    for BST, the CTR ``mlp`` over the flat ``[(seq_len + 1)·d]`` hidden
    states."""

    def __init__(self, item_emb, pos_emb, blocks: list[Block],
                 final_ln: nnl.LayerNorm, mlp: nnl.MLP | None = None):
        super().__init__()
        self.item_emb = nnl._param(item_emb)
        self.pos_emb = nnl._param(pos_emb)
        self.blocks = nn.ModuleList(blocks)
        self.final_ln = final_ln
        self.mlp = mlp

    def tree(self) -> dict:
        t = {"item_emb": {"emb": self.item_emb},
             "pos_emb": {"emb": self.pos_emb},
             "blocks": {f"block_{i}": b.tree()
                        for i, b in enumerate(self.blocks)},
             "final_ln": self.final_ln.tree()}
        if self.mlp is not None:
            t["mlp"] = self.mlp.tree()
        return t


# ----------------------------------------------------------------------------
# shared sequence encoder (pre-LN transformer blocks over item embeddings)
# ----------------------------------------------------------------------------
def _block_init(d: int, *, generator: torch.Generator) -> Block:
    g, dev = generator, generator.device

    def dense():
        return nnl.dense_init(d, d, generator=g)

    wq, wk, wv, wo, w1, w2 = (dense() for _ in range(6))
    return Block(nnl.layernorm_init(d, device=dev), wq, wk, wv, wo,
                 nnl.layernorm_init(d, device=dev),
                 w1, torch.zeros(d, device=dev), w2,
                 torch.zeros(d, device=dev))


def _block(blk: Block, x, cfg: RecSysConfig, *, causal: bool, dtype):
    B, L, d = x.shape
    H = cfg.n_heads
    dh = d // H
    qc = kc = max(16, 1 << (L - 1).bit_length())  # whole seq in one chunk
    h = nnl.layernorm(blk.ln1, x, dtype=dtype)
    q = nnl.dense(blk.wq, h, dtype=dtype).reshape(B, L, H, dh)
    k = nnl.dense(blk.wk, h, dtype=dtype).reshape(B, L, H, dh)
    v = nnl.dense(blk.wv, h, dtype=dtype).reshape(B, L, H, dh)
    o = attn.flash_attention(q, k, v, causal=causal, q_chunk=min(qc, L),
                             kv_chunk=min(kc, L), dtype=dtype)
    x = x + nnl.dense(blk.wo, o.reshape(B, L, d), dtype=dtype)
    h = nnl.layernorm(blk.ln2, x, dtype=dtype)
    h = torch.relu(h @ blk.w1.to(dtype) + blk.b1.to(dtype))
    h = h @ blk.w2.to(dtype) + blk.b2.to(dtype)
    return x + h


def _encode_seq(blocks, x, cfg: RecSysConfig, *, causal: bool, dtype,
                remat: bool = False):
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(lambda y, b=blk: _block(b, y, cfg, causal=causal,
                                                   dtype=dtype),
                           x, use_reentrant=False)
        else:
            x = _block(blk, x, cfg, causal=causal, dtype=dtype)
    return x


def init_params(cfg: RecSysConfig, *, generator: torch.Generator | None = None,
                seed: int = 0, device=None):
    """Random parameters on ``device`` (default: the card), drawn from
    ``generator`` (default: one on ``device`` seeded with ``seed``):
    a :class:`TwoTower` for ``kind="two_tower"``, else a :class:`SeqRec`."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    g = generator
    if cfg.kind == "two_tower":  # no sequence encoder: bag + towers only
        return TwoTower(
            nnl.embedding_init(cfg.user_rows, cfg.id_dim, generator=g),
            nnl.embedding_init(cfg.vocab_rows, cfg.id_dim, generator=g),
            nnl.mlp_init((cfg.id_dim * 2,) + cfg.mlp_dims, generator=g),
            nnl.mlp_init((cfg.id_dim,) + cfg.mlp_dims, generator=g))
    if cfg.kind not in ("sasrec", "bert4rec", "bst"):
        raise ValueError(cfg.kind)
    d = cfg.embed_dim
    item = nnl.embedding_init(cfg.vocab_rows, d, generator=g)
    pos = nnl.embedding_init(cfg.seq_len + 1, d, generator=g)
    blocks = [_block_init(d, generator=g) for _ in range(cfg.n_blocks)]
    mlp = (nnl.mlp_init(((cfg.seq_len + 1) * d,) + cfg.mlp_dims + (1,),
                        generator=g) if cfg.kind == "bst" else None)
    return SeqRec(item, pos, blocks, nnl.layernorm_init(d, device=g.device),
                  mlp)


def _seq_repr(params: SeqRec, hist, cfg: RecSysConfig, *, causal: bool,
              dtype, remat: bool = False):
    """hist [B, L] -> hidden [B, L, d] with positional embeddings."""
    L = hist.shape[1]
    x = _lookup(params, params.item_emb, hist, dtype)
    pos = torch.arange(L, dtype=torch.int32, device=hist.device)[None]
    x = x + nnl.embedding_lookup(params.pos_emb, pos, dtype=dtype)
    x = _encode_seq(params.blocks, x, cfg, causal=causal, dtype=dtype,
                    remat=remat)
    return nnl.layernorm(params.final_ln, x, dtype=dtype)


def _item_scores(params: SeqRec, h, item_ids, dtype):
    """h [..., d] · emb[item_ids] [..., C, d] -> [..., C] (dot-product head),
    float32 products and sums."""
    vecs = _lookup(params, params.item_emb, item_ids, dtype)
    return accum_matmul("...d,...cd->...c", h, vecs)


def view(params):
    """``params`` as the model code reads them: a model as it is; a
    ``tensor_parallel.ModelParallel`` (one data position's copy over the
    ``model`` axis) as the same attributes, each leaf a tensor at its home
    or its ``tensor_parallel.Slices``, and ``home``."""
    from repro_torch.distributed.tensor_parallel import ModelParallel

    if not isinstance(params, ModelParallel):
        return params
    v, paths = params.view, params.leaves

    def ln(prefix):
        return SimpleNamespace(scale=v(f"{prefix}/scale"),
                               bias=v(f"{prefix}/bias"))

    def mlp(prefix):
        n = sum(1 for k in paths if k.startswith(f"{prefix}/layer_")
                and k.endswith("/w"))
        return SimpleNamespace(w=[v(f"{prefix}/layer_{i}/w") for i in range(n)],
                               b=[v(f"{prefix}/layer_{i}/b") for i in range(n)])

    if "user_emb/emb" in paths:
        return SimpleNamespace(
            home=params.home, user_emb=v("user_emb/emb"),
            item_id_emb=v("item_id_emb/emb"), user_mlp=mlp("user_mlp"),
            item_mlp=mlp("item_mlp"))
    n_blocks = len({k.split("/")[1] for k in paths if k.startswith("blocks/")})
    blocks = []
    for i in range(n_blocks):
        b = f"blocks/block_{i}"
        blocks.append(SimpleNamespace(
            ln1=ln(f"{b}/ln1"), ln2=ln(f"{b}/ln2"),
            **{w: v(f"{b}/attn/{w}/w") for w in ("wq", "wk", "wv", "wo")},
            w1=v(f"{b}/ffn/w1/w"), b1=v(f"{b}/ffn/w1/b"),
            w2=v(f"{b}/ffn/w2/w"), b2=v(f"{b}/ffn/w2/b")))
    return SimpleNamespace(
        home=params.home, item_emb=v("item_emb/emb"), pos_emb=v("pos_emb/emb"),
        blocks=blocks, final_ln=ln("final_ln"),
        mlp=mlp("mlp") if any(k.startswith("mlp/") for k in paths) else None)


def _lookup(params, table, ids, dtype):
    """``table[ids]`` in ``dtype``: a table split over ``model`` looked up
    where its slices lie (``tensor_parallel.lookup``)."""
    if isinstance(table, tp.Slices):
        return tp.lookup(table, ids, home=params.home, dtype=dtype)
    return nnl.embedding_lookup(table, ids, dtype=dtype)


def _mlp(params, layers, x, *, act=torch.relu, dtype):
    """``nn.layers.mlp``, or ``tensor_parallel.mlp`` where a layer is split
    over ``model``."""
    if any(isinstance(w, tp.Slices) for w in layers.w):
        return tp.mlp(layers, x, home=params.home, act=act, dtype=dtype)
    return nnl.mlp(layers, x, act=act, dtype=dtype)


def _leaky_relu(x):
    # jax.nn.leaky_relu: the slope, a weakly typed 0.01, in x's dtype
    return torch.where(x >= 0, x,
                       x * torch.tensor(0.01, dtype=x.dtype, device=x.device))


# ----------------------------------------------------------------------------
# losses (train_step targets)
# ----------------------------------------------------------------------------
def loss_fn(params, batch, cfg: RecSysConfig, *,
            dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """``(loss, aux)`` of a train batch (``data.synthetic.recsys_batch``'s
    leaves as tensors), computed as :func:`train_options` picks for its
    size (the same function either way). ``params`` may be a
    ``ModelParallel`` (the rule's splits over ``model``), or a
    ``data_parallel.RowSplit`` with ``batch`` its positions' parts: each
    position's per-row terms, joined at home in position order, reduced
    once, as one batch's (one device's batch is the one-position case).
    The two-tower softmax reads every position's item vectors
    (:func:`_two_tower_loss`)."""
    split, parts = _positions(params, batch)
    rows = sum(next(iter(b.values())).shape[0] for b in parts)
    opts = train_options(cfg, rows)
    if cfg.kind == "two_tower":
        return _two_tower_loss(split, parts, cfg, dtype, opts["loss_chunk"])
    terms = [_loss_terms(view(r), b, cfg, dtype, opts["remat"])
             for r, b in zip(split.replicas, parts)]
    return _reduce(cfg.kind, {k: split.gather([t[k] for t in terms])
                              for k in terms[0]})


def _positions(params, batch):
    """``(RowSplit, parts)``: a ``RowSplit`` and its parts as given, or one
    device's parameters and batch as one position."""
    from repro_torch.distributed.data_parallel import RowSplit

    if isinstance(params, RowSplit):
        return params, batch
    return RowSplit.one(params, batch), [batch]


def train_options(cfg: RecSysConfig, batch: int) -> dict:
    """How :func:`loss_fn` computes a batch of ``batch`` rows on one card:
    ``remat`` (recompute each encoder block in the backward pass) where
    the encoder's saved activations (some 16 bf16 ``[B, L, d]`` tensors a
    block) would pass 16 GB (BERT4Rec at 65,536 rows: ~107 GB), and the
    two-tower loss in chunks of ``loss_chunk`` rows where its float32
    ``[B, B]`` logits would pass 1 GiB (17.2 GB at 65,536 rows)."""
    if cfg.kind == "two_tower":
        chunk = max(1, (1 << 30) // (4 * batch))
        return {"loss_chunk": chunk if chunk < batch else None}
    acts = 16 * 2 * batch * (cfg.seq_len + 1) * cfg.embed_dim * cfg.n_blocks
    return {"remat": acts > 16e9}


def _loss_terms(params, batch, cfg, dtype, remat=False) -> dict:
    """The per-row terms of a SASRec, BERT4Rec or BST loss (:func:`_reduce`
    reduces them)."""
    if cfg.kind == "sasrec":
        return _sasrec_terms(params, batch, cfg, dtype, remat)
    if cfg.kind == "bert4rec":
        return _bert4rec_terms(params, batch, cfg, dtype, remat)
    if cfg.kind == "bst":
        return _bst_terms(params, batch, cfg, dtype, remat)
    raise ValueError(cfg.kind)


def _reduce(kind: str, t: dict):
    """``(loss, aux)`` from a whole batch's per-row terms: the masked means
    divide by the valid count, BST's plain means by the rows."""
    if kind == "bst":
        return -torch.mean(t["ll"]), {"accuracy": torch.mean(t["acc"])}
    n = torch.clamp(t["valid"].sum(), min=1)
    if kind == "sasrec":
        return -t["ll"].sum() / n, {"pairwise_acc": t["hit"].sum() / n}
    return t["nll"].sum() / n, {"hit_at_1": t["hit"].sum() / n}


def _sasrec_loss(params, batch, cfg, dtype, remat=False):
    return _reduce("sasrec", _sasrec_terms(params, batch, cfg, dtype, remat))


def _bert4rec_loss(params, batch, cfg, dtype, remat=False):
    return _reduce("bert4rec", _bert4rec_terms(params, batch, cfg, dtype,
                                               remat))


def _bst_loss(params, batch, cfg, dtype, remat=False):
    return _reduce("bst", _bst_terms(params, batch, cfg, dtype, remat))


def _sasrec_terms(params, batch, cfg, dtype, remat=False):
    """Next-item binary CE with one sampled negative per step (SASRec
    §3.5)."""
    hist = batch["hist"]  # [B, L+1]
    neg = batch["neg"]  # [B, L]
    inputs, pos = hist[:, :-1], hist[:, 1:]
    h = _seq_repr(params, inputs, cfg, causal=True, dtype=dtype, remat=remat)
    pos_s = _item_scores(params, h, pos[..., None], dtype)[..., 0]
    neg_s = _item_scores(params, h, neg[..., None], dtype)[..., 0]
    valid = pos != 0
    lp = F.logsigmoid(pos_s)
    ln = F.logsigmoid(-neg_s)
    return {"ll": torch.where(valid, lp + ln, 0.0), "valid": valid,
            "hit": valid & (pos_s > neg_s)}


def _bert4rec_terms(params, batch, cfg, dtype, remat=False):
    """Masked-item sampled softmax with shared negatives (+ target in slot
    0)."""
    hist = batch["hist"]  # [B, L] with [MASK]=n_items+1 at masked slots
    mask_pos = batch["mask_pos"]  # [B, M]
    targets = batch["targets"]  # [B, M]
    negatives = batch["negatives"]  # [Nneg]
    h = _seq_repr(params, hist, cfg, causal=False, dtype=dtype, remat=remat)
    idx = mask_pos.to(torch.int64)[..., None].expand(-1, -1, h.shape[-1])
    hm = torch.gather(h, 1, idx)  # [B, M, d]
    pos_s = _item_scores(params, hm, targets[..., None], dtype)[..., 0]
    neg_v = _lookup(params, params.item_emb, negatives, dtype)
    neg_s = accum_matmul("bmd,nd->bmn", hm, neg_v)
    logits = torch.cat([pos_s[..., None], neg_s], dim=-1)  # [B, M, 1+N]
    del neg_s  # 8 GB at the train_batch shape; the backward needs neither
    valid = targets != 0
    nll = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    hit = logits[..., 0] >= logits.amax(dim=-1)
    return {"nll": torch.where(valid, nll, 0.0), "valid": valid,
            "hit": valid & hit}


def _bst_terms(params, batch, cfg, dtype, remat=False):
    """CTR binary cross-entropy (BST: transformer over history + target
    item)."""
    logit = bst_forward(params, batch["hist"], batch["target"], cfg,
                        dtype=dtype, remat=remat)
    label = batch["label"].to(torch.float32)
    return {"ll": label * F.logsigmoid(logit)
            + (1 - label) * F.logsigmoid(-logit),
            "acc": ((logit > 0) == (label > 0.5)).to(torch.float32)}


def bst_forward(params: SeqRec, hist, target, cfg: RecSysConfig, *,
                dtype=nnl.DEFAULT_COMPUTE_DTYPE, remat: bool = False):
    seq = torch.cat([hist, target[:, None].to(hist.dtype)], dim=1)  # [B, L+1]
    h = _seq_repr(params, seq, cfg, causal=False, dtype=dtype, remat=remat)
    flat = h.reshape(h.shape[0], -1)
    return _mlp(params, params.mlp, flat, act=_leaky_relu,
                dtype=dtype)[:, 0].to(torch.float32)


def _normalize(v, dtype):
    norm = torch.linalg.vector_norm(v.float(), dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=1e-6).to(dtype)


def user_tower(params: TwoTower, user_id, hist, cfg: RecSysConfig, *,
               dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    u = _lookup(params, params.user_emb, user_id, dtype)  # [B, id_dim]
    bag = bag_from_padded(params.item_id_emb, hist, mode="mean", dtype=dtype,
                          home=getattr(params, "home", None))
    x = torch.cat([u, bag], dim=-1)
    return _normalize(_mlp(params, params.user_mlp, x, dtype=dtype), dtype)


def user_tower_compressed(params: TwoTower, user_id, hists,
                          cfg: RecSysConfig, *, plan="auto",
                          dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """User tower over compressed histories: the mean-bag is kernel 2's
    ``bag_sum`` epilogue on the card. ``hists`` is
    ``CompressedIntArray.encode_ragged(histories, block_size=seq_len)``,
    one block per user. Matches ``user_tower`` when the padded histories
    hold the same ids (pad id 0 excluded)."""
    from repro_torch.nn.embedding_bag import embedding_bag_compressed

    u = nnl.embedding_lookup(params.user_emb, user_id, dtype=dtype)
    bag = embedding_bag_compressed(params.item_id_emb, hists, mode="mean",
                                   plan=plan, dtype=dtype)[: u.shape[0]]
    x = torch.cat([u, bag.to(dtype)], dim=-1)
    return _normalize(nnl.mlp(params.user_mlp, x, dtype=dtype), dtype)


def item_tower(params: TwoTower, item_ids, cfg: RecSysConfig, *,
               dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    x = _lookup(params, params.item_id_emb, item_ids, dtype)
    return _normalize(_mlp(params, params.item_mlp, x, dtype=dtype), dtype)


def item_table(params: TwoTower, cfg: RecSysConfig, *,
               dtype=nnl.DEFAULT_COMPUTE_DTYPE,
               chunk: int = 1 << 20) -> torch.Tensor:
    """``item_tower`` over the whole (rounded) vocabulary, ``[vocab_rows,
    d]`` in ``dtype``, computed ``chunk`` rows at a time: rows are
    independent, and the whole vocabulary at once would hold a
    ``[vocab_rows, 1024]`` intermediate (17.2 GB at 2^23 items)."""
    dev = params.item_id_emb.device
    V = cfg.vocab_rows
    out = None
    for s in range(0, V, chunk):
        ids = torch.arange(s, min(s + chunk, V), device=dev)
        t = item_tower(params, ids, cfg, dtype=dtype).to(dtype)
        if out is None:
            out = torch.empty((V, t.shape[1]), dtype=dtype, device=dev)
        out[s:s + t.shape[0]] = t
    return out


TEMPERATURE = 0.05  # the two-tower in-batch softmax's


def _in_batch_rows(u, i, start: int):
    """Rows ``start:start + len(u)`` of the in-batch softmax: each row's
    ``-log p`` of its own item, and whether its argmax (the first maximum)
    is its own item. ``i`` may come widened to float32 (an exact copy):
    the product is in ``u``'s dtype either way."""
    logits = (u @ i.to(u.dtype).T).to(torch.float32) / TEMPERATURE  # [c, B]
    rows = torch.arange(u.shape[0], device=u.device)
    logp = torch.log_softmax(logits, dim=-1)
    return (-logp[rows, start + rows],
            torch.argmax(logits, dim=-1) == start + rows)


def _in_batch(u, i, start: int, loss_chunk=None):
    """Rows ``start:start + len(u)`` of the in-batch softmax over the item
    rows ``i`` (every row's), ``loss_chunk`` rows at a time when given
    (``i`` then widened to float32, so that the chunks' gradients for it
    add in float32 and round to the compute dtype once): ``(nll, hit)``."""
    R = u.shape[0]
    if loss_chunk is None:
        return _in_batch_rows(u, i, start)
    c = max(1, min(loss_chunk, R))
    parts = [checkpoint(_in_batch_rows, u[s:s + c], i, start + s,
                        use_reentrant=False) if torch.is_grad_enabled()
             else _in_batch_rows(u[s:s + c], i, start + s)
             for s in range(0, R, c)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _two_tower_reduce(nll, hit):
    return nll.mean(), {"in_batch_top1": hit.to(torch.float32).mean()}


def _two_tower_loss(params, batch, cfg, dtype, loss_chunk=None):
    """In-batch sampled softmax (Yi et al., RecSys'19), temperature-scaled;
    ``loss_chunk`` rows at a time when given (the same function). Over a
    ``RowSplit`` (``params``, with ``batch`` its parts) every row's logits
    run over every position's item vectors (``RowSplit.share``)."""
    split, parts = _positions(params, batch)
    views = [view(r) for r in split.replicas]
    us = [user_tower(v, b["user_id"], b["hist"], cfg, dtype=dtype)
          for v, b in zip(views, parts)]
    its = [item_tower(v, b["item_id"], cfg, dtype=dtype)
           for v, b in zip(views, parts)]
    rows = sum(u.shape[0] for u in us)
    c = None if loss_chunk is None or loss_chunk >= rows else loss_chunk
    if c is not None:  # widened, as the chunks take them
        its = [i.to(torch.float32) for i in its]
    items = split.share(its)
    nll, hit, start = [], [], 0
    for u, iw in zip(us, items):
        a, b = _in_batch(u, iw, start, c)
        nll.append(a)
        hit.append(b)
        start += u.shape[0]
    return _two_tower_reduce(split.gather(nll), split.gather(hit))


# ----------------------------------------------------------------------------
# serve steps
# ----------------------------------------------------------------------------
def serve_scores(params, batch, cfg: RecSysConfig, *,
                 dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """Online/bulk scoring against a candidate set (serve_p99 /
    serve_bulk): BST ``[B]`` CTR logits; else ``[B, C]`` scores of each
    row's candidates (two-tower: one candidate list ``[C]`` for all).
    ``params`` may be a ``ModelParallel``: the serving rule's splits."""
    params = view(params)
    if cfg.kind == "bst":
        return bst_forward(params, batch["hist"], batch["target"], cfg,
                           dtype=dtype)
    if cfg.kind == "two_tower":
        u = user_tower(params, batch["user_id"], batch["hist"], cfg,
                       dtype=dtype)
        i = item_tower(params, batch["cands"], cfg, dtype=dtype)  # [C]
        return (u @ i.T).to(torch.float32)
    causal = cfg.kind == "sasrec"
    h = _seq_repr(params, batch["hist"], cfg, causal=causal, dtype=dtype)
    return _item_scores(params, h[:, -1], batch["cands"], dtype)  # [B, C]


def topk_lower_index(scores: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, equal
    scores ordered by lower index first (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


BST_ROWS = 1 << 16  # candidates a BST ranker pass scores at once


def retrieval_scores_compressed(params, batch, cfg: RecSysConfig, *,
                                top_k: int = 100, plan="auto",
                                dtype=nnl.DEFAULT_COMPUTE_DTYPE,
                                score_fn=None):
    """retrieval_cand: score one query against a compressed candidate list.

    ``batch["cands"]`` is the sorted candidate ids as a
    ``CompressedIntArray`` (delta-coded, any format); ``batch["hist"]``
    ``[1, seq_len]`` and, for two-tower, ``batch["user_id"]`` ``[1]``. The
    query (:func:`retrieval_query`) scores every candidate
    (:func:`score_candidates`); one top-k over the scores. Returns
    ``(scores [C], (top scores, top ids))``, where ``C`` counts every slot
    of the decoded grid (pad slots are id 0, as in the reference).
    ``plan="auto"`` decodes with the kernels on the card (the reference's
    off-TPU switch to its gather-lowered decoder is a TPU lowering
    choice; the decoded ids are the same). ``score_fn`` (the arguments of
    :func:`score_candidates`) scores in its place: ``registry.run_cell``
    scores a mesh's candidate shards with it. ``params`` may be a
    ``ModelParallel``. The reference's deprecated unpacked ``cand_*``
    batch keys are not ported.
    """
    params = view(params)
    query = retrieval_query(params, batch, cfg, dtype=dtype)
    ids, scores = (score_fn or score_candidates)(
        params, query, batch["cands"], cfg, plan=plan, dtype=dtype)
    top_s, top_i = topk_lower_index(scores, top_k)
    return scores, (top_s, ids[top_i])


def retrieval_query(params, batch, cfg: RecSysConfig, *,
                    dtype=nnl.DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """What a ``retrieval_cand`` request scores its candidates by: the last
    hidden state ``[1, d]`` (SASRec, BERT4Rec), the user vector ``[1, v]``
    (two-tower), or the history ``[1, seq_len]`` (BST's ranker)."""
    if cfg.kind in ("sasrec", "bert4rec"):
        return _seq_repr(params, batch["hist"], cfg,
                         causal=cfg.kind == "sasrec", dtype=dtype)[:, -1]
    if cfg.kind == "two_tower":
        return user_tower(params, batch["user_id"], batch["hist"], cfg,
                          dtype=dtype)
    if cfg.kind == "bst":
        return batch["hist"]
    raise ValueError(cfg.kind)


def score_candidates(params, query, cands, cfg: RecSysConfig, *,
                     table=None, plan="auto",
                     dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """``(ids [C], scores [C])`` of the candidates ``cands`` (a
    ``CompressedIntArray``), decoded where they lie. The dot-product
    heads (SASRec, BERT4Rec) score in one pass of kernel 2's ``dot_score``
    epilogue on the card: the candidates' rows of ``table`` (default: the
    item table in ``dtype``, on the candidates' device) dot ``query``, and
    only ids and scores come out. The tower and ranker heads decode
    (kernel 1), then score at ``query``'s device: two-tower through the
    item tower, BST through the whole ranker per candidate, ``BST_ROWS``
    candidates at a time (rows are independent; all 2^20 at once would
    hold a ``[2^20, 8, 21, 21]`` float32 attention)."""
    from repro_torch.kernels.vbyte_decode import dispatch

    if cfg.kind in ("sasrec", "bert4rec"):
        if table is None:
            table = params.item_emb.to(dtype)
        ids, scores = dispatch.decode(
            cands, epilogue="dot_score", plan=plan, epilogue_operands={
                "table": table, "query": query.to(table.device)})
        return ids.reshape(-1), scores.reshape(-1)
    ids = dispatch.decode(cands, plan=plan).reshape(-1)
    c = ids.to(query.device)
    if cfg.kind == "two_tower":
        i = item_tower(params, c, cfg, dtype=dtype)  # [C, v]
        return ids, (i @ query[0]).to(torch.float32)
    if cfg.kind == "bst":  # every candidate through the ranker
        return ids, torch.cat([
            bst_forward(params, query.expand(len(x), -1), x, cfg,
                        dtype=dtype) for x in c.split(BST_ROWS)])
    raise ValueError(cfg.kind)
