"""Analytic per-device cost model: FLOPs, HBM bytes and wire bytes of a cell.

The port of ``repro/launch/cost_model.py``, with the reference's terms and
values, so that a cell's modelled cost is the same number in both packages
(``tests/test_torch_analysis_tools.py``). It counts every matmul, gather
and collective a step runs, times its trip count; ``launch/dryrun.py``
puts it beside the bytes a card holds and ``launch/roofline_math.py``
turns it into a roofline on one H100. These are modelled costs, not
measurements of any device.

The reference wrote its assumptions for its TPU program. What each one
means for the port:

* flash attention's scores and softmax stay in VMEM, so only q, k, v and
  o reach HBM. The port's attention on the card is SDPA (flash or memory-
  efficient kernels), whose scores stay in shared memory and registers:
  the same traffic;
* weights are stored float32 and read once a pass (forward, recomputed
  forward, backward: 3 reads a microbatch). The port's train step keeps
  float32 master weights and recomputes each layer in the backward
  (``models/lm.py``), so the same three passes read them;
* AdamW touches 12 float32 words a parameter a step (p, m, v read and
  written) plus the gradient's read and write: the port's
  ``train/optimizer.py::adamw_update`` reads and writes the same words;
* the tensor-parallel sums fire once a layer a microbatch (the
  row-parallel sum of the ``[tokens, d]`` activations, bf16) and the
  data-parallel gradient all-reduce once a step on float32 gradients,
  where GSPMD placed them on the TPU. The port's mesh runs from one
  controller (``distributed/``): a "collective" is a copy between the
  positions' devices (over NVLink between cards, or within one card for
  logical shards), and the ring's ``(n - 1) / n`` factor is kept as the
  bytes a position sends;
* the decode terms (``decode_cost``) price the blocked decode at ~2
  compressed bytes an integer, with the 8-byte round trip of the decoded
  stream that an unfused plan adds: the same traffic for the CUDA
  kernels (kernel 2 fuses the consumer, the decode kernels write the
  grid).

One guard the reference lacks: with a ``model`` axis of 1 an
expert-parallel MoE has no all-to-all, where the reference divides 0 by
0; the port counts 0 wire bytes (a mesh of ``(cards, 1)``).
"""
from __future__ import annotations

from dataclasses import dataclass

BF16 = 2
F32 = 4


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.wire_bytes + o.wire_bytes)

    def scale(self, k: float):
        return Cost(self.flops * k, self.bytes * k, self.wire_bytes * k)


# ----------------------------------------------------------------------------
# VByte decode cost: fused vs unfused epilogues
# ----------------------------------------------------------------------------
# Traffic per decoded int: ~2 B compressed read; an unfused decode also
# writes the uint32 stream and reads it back (8 B) — the round trip the
# fused epilogues remove.
DECODE_INT_OPS = 30
DECODE_READ_B = 2.0
DECODE_RT_B = 8.0  # unfused-only: u32 write + consumer re-read

# Per-codec decode costs, a per-int and a per-block term (the block's
# fixed setup, amortised over it): vbyte pays the boundary recovery,
# streamvbyte routes bytes through the control stream, binpack is a shift
# and mask. The index builder's block-partition DP prices its edges with
# them (``index/partition.py``), so both packages pick the same
# partitions and codecs.
CODEC_INT_OPS = {"vbyte": float(DECODE_INT_OPS), "streamvbyte": 18.0,
                 "binpack": 8.0}
CODEC_BLOCK_OPS = {"vbyte": 320.0, "streamvbyte": 256.0, "binpack": 96.0}


def decode_cost(n_ints: float, *, fused: bool) -> Cost:
    """Per-device decode cost; ``fused``: the consumer runs in the same
    launch (kernel 2's epilogue)."""
    b = DECODE_READ_B + (0.0 if fused else DECODE_RT_B)
    return Cost(DECODE_INT_OPS * n_ints, b * n_ints)


def codec_decode_cost(n_ints: float, *, format: str = "vbyte",
                      fused: bool = True, n_blocks: float = 0.0) -> Cost:
    """Per-codec decode cost (per-int + per-block tile terms), used by the
    index builder's block-partition DP to trade encoded bits against
    modelled decode work."""
    ops = (CODEC_INT_OPS.get(format, float(DECODE_INT_OPS)) * n_ints
           + CODEC_BLOCK_OPS.get(format, 0.0) * n_blocks)
    b = DECODE_READ_B + (0.0 if fused else DECODE_RT_B)
    return Cost(ops, b * n_ints)


def _ring(n: int, nbytes: float, *, reduce: bool = False) -> float:
    """Bytes a position sends in a ring gather (or, with ``reduce``, an
    all-reduce) of ``nbytes`` over ``n`` positions."""
    if n <= 1:
        return 0.0
    return (2 if reduce else 1) * (n - 1) / n * nbytes


# ----------------------------------------------------------------------------
# LM
# ----------------------------------------------------------------------------
def _lm_layer_params_local(cfg, tp: int) -> tuple[float, float]:
    """(stored param count/device, active-matmul param count/device) per
    layer."""
    d, dh = cfg.d_model, cfg.dh
    kv_shard = cfg.n_kv_heads % tp == 0
    attn = (d * cfg.n_heads * dh * 2 / tp
            + d * cfg.n_kv_heads * dh * 2 / (tp if kv_shard else 1))
    if cfg.moe:
        stored = (attn + 3 * cfg.moe.n_experts * d * cfg.moe.d_ff / tp
                  + d * cfg.moe.n_experts)
        active = (attn + 3 * cfg.moe.top_k * cfg.moe.capacity_factor * d
                  * cfg.moe.d_ff / tp + d * cfg.moe.n_experts)
    else:
        stored = active = attn + 3 * d * cfg.d_ff / tp
    return stored, active


def lm_cost(cfg, shape, *, n_chips: int, dp: int, tp: int = 16,
            assembly: dict | None = None) -> Cost:
    assembly = assembly or {}
    dims, step = shape.dims, shape.step
    B, S = dims["global_batch"], dims["seq_len"]
    d, dh, V = cfg.d_model, cfg.dh, cfg.vocab
    L = cfg.n_layers
    h_loc = max(cfg.n_heads // tp, 1)
    stored_l, active_l = _lm_layer_params_local(cfg, tp)
    P_emb_head = 2 * V * d / tp
    P_stored = L * stored_l + P_emb_head + d

    if step in ("train", "prefill"):
        mu = cfg.microbatch if step == "train" else 1
        B_mu = max(B // dp, 1) / mu  # local batch per microstep
        t = B_mu * S  # local tokens per microstep
        s_kv = (min(cfg.window + cfg.q_chunk, S)
                if (cfg.window and cfg.banded_attention) else S)
        c = Cost()

        # per layer per microstep, forward
        f_mm = 2 * t * active_l
        f_attn = 4 * B_mu * h_loc * dh * S * s_kv
        w_bytes = stored_l * F32
        a_attn = 6 * t * h_loc * dh * BF16  # q,k,v,o (+rope) traffic
        f_act = (t * cfg.moe.d_ff / tp * cfg.moe.top_k
                 * cfg.moe.capacity_factor if cfg.moe
                 else t * cfg.d_ff / tp)
        a_bytes = (8 * t * d + 3 * f_act) * BF16 + a_attn
        if cfg.moe:  # dispatch/combine buffer traffic (gather + scatter, x2)
            a_bytes += (4 * t * cfg.moe.top_k * cfg.moe.capacity_factor * d
                        * BF16)
        fwd = Cost(f_mm + f_attn, w_bytes + a_bytes)
        # TP collectives: 2 row-parallel sums of [t, d] bf16 per layer
        fwd.wire_bytes = 2 * _ring(tp, t * d * BF16, reduce=True)
        if cfg.moe and cfg.moe.ep_shard and tp > 1:
            # token->expert all-to-all (dispatch + combine)
            fwd.wire_bytes += 2 * _ring(tp, t * cfg.moe.top_k
                                        * cfg.moe.capacity_factor * d
                                        * BF16) / (tp - 1)

        if step == "prefill":
            layer = fwd
            passes = 1.0
        else:
            refwd = fwd
            if getattr(cfg, "remat_policy", "full") == "save_block_outputs":
                # block outputs checkpointed: the recomputed forward redoes
                # the internals but not the summed output projections
                refwd = Cost(0.9 * (f_mm + f_attn), w_bytes + a_bytes, 0.0)
            bwd = Cost(2 * (f_mm + f_attn),
                       w_bytes + stored_l * F32 + 1.7 * a_bytes,
                       2 * fwd.wire_bytes)
            layer = fwd + refwd + bwd
            passes = 3.0  # head/embed has no recomputation: fwd+bwd(2x)

        c = c + layer.scale(L * mu)

        # lm head (+ loss) and embedding
        head = Cost(2 * t * d * V / tp * passes,
                    (2 * V * d / tp) * F32 * (2 if step == "train" else 1)
                    + t * V / tp * F32 * (2 if step == "train" else 0.0)
                    + t * d * BF16 * 3)
        if step == "prefill":  # only last-token logits
            head = Cost(2 * B_mu * d * V / tp,
                        (V * d / tp) * F32 + B_mu * V / tp * F32)
        emb = Cost(0, t * d * BF16 * (2 if step == "train" else 1))
        c = c + (head + emb).scale(mu)

        if step == "train":
            if assembly.get("zero1"):
                # ZeRO-1: master and moments split dp ways; a bf16 weight
                # gather once a step; a bf16 gradient reduce-scatter a
                # microstep
                c = c + Cost(12 * P_stored / dp, 13 * P_stored / dp * F32
                             + P_stored * BF16,
                             _ring(dp, P_stored * BF16)  # weight gather
                             + mu * _ring(dp, P_stored * BF16))  # grad RS
            else:
                # baseline: f32 gradient all-reduce over DP, dense AdamW
                c = c + Cost(12 * P_stored, 13 * P_stored * F32,
                             _ring(dp, P_stored * F32, reduce=True))
        return c

    # decode: one token, KV cache resident
    from repro_torch.models.lm import cache_size

    sc = cache_size(cfg, S)
    if B >= dp:
        B_loc, sc_loc = B / dp, sc
    else:
        B_loc, sc_loc = B, sc / dp  # the cache split by sequence (long_500k)
    kv_shard = cfg.n_kv_heads % tp == 0
    kvh_loc = cfg.n_kv_heads / tp if kv_shard else cfg.n_kv_heads
    dh_loc = dh if kv_shard else dh / tp
    t = B_loc
    f_mm = 2 * t * (L * active_l + 2 * V * d / tp / 2)  # + head, no embed
    f_attn = 4 * L * B_loc * h_loc * dh * sc_loc
    w_bytes = (L * stored_l + P_emb_head) * BF16  # serve weights bf16
    cache_bytes = 2 * L * B_loc * sc_loc * kvh_loc * dh_loc * BF16  # K+V
    act = L * 12 * t * d * BF16
    wire = L * 2 * _ring(tp, t * d * BF16, reduce=True)
    if not kv_shard:  # scores summed over a head-dimension-split cache
        wire += L * 2 * _ring(tp, B_loc * cfg.n_heads * sc_loc * F32 / tp,
                              reduce=True)
    return Cost(f_mm + f_attn, w_bytes + cache_bytes + act, wire)


# ----------------------------------------------------------------------------
# GNN
# ----------------------------------------------------------------------------
def gnn_cost(cfg, shape, *, n_chips: int, dp: int, tp: int = 16) -> Cost:
    dims = shape.dims
    N, E, F = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
    h, L = cfg.d_hidden, cfg.n_layers
    shard = n_chips if dims.get("task", "node") == "node" else 1
    N_loc, E_loc = N / shard, E / shard
    agg_b = BF16 if getattr(cfg, "agg_dtype", "f32") == "bf16" else F32
    # per layer: gather msgs [E, din] + segment sum + 2-layer MLP
    c = Cost()
    for i in range(L):
        din = F if i == 0 else h
        mm = 2 * N_loc * (din * h + h * h)
        # the messages read the gathered h replica (N·din written whole,
        # E_loc rows read) and add into the partial [N, din]
        gather = (N + E_loc) * din * agg_b + N * din * agg_b
        acts = 4 * N_loc * (din + h) * BF16
        # every position holds a whole [N, din] partial (random
        # destinations), summed across positions, plus the gather of h;
        # the reference's factor 1.3 (read from its compiled program's
        # collectives) kept
        wire = _ring(n_chips if shard > 1 else 1, N * din * agg_b,
                     reduce=True)
        wire += _ring(n_chips if shard > 1 else 1, N * din * agg_b)
        c = c + Cost(mm * 3.0, (gather + acts) * 3.0, wire * 1.3)  # fwd+bwd
    if cfg.compressed_adjacency:
        # adjacency_rebase epilogue: fused unless the plan forces two passes
        fused = getattr(cfg, "decode_plan", "auto") != "unfused"
        c = c + decode_cost(E_loc, fused=fused)
    P = cfg.param_count()
    c = c + Cost(12 * P, 13 * P * F32, _ring(n_chips, P * F32, reduce=True))
    return c


# ----------------------------------------------------------------------------
# RecSys
# ----------------------------------------------------------------------------
def recsys_cost(cfg, shape, *, n_chips: int, dp: int, tp: int = 16) -> Cost:
    dims, step = shape.dims, shape.step
    per_ex = cfg.dense_flops_per_example()
    d = cfg.embed_dim

    if step == "train":
        B_loc = dims["batch"] / dp
        ids_per_ex = cfg.seq_len + 2
        emb_dim = cfg.id_dim if cfg.kind == "two_tower" else d
        gather = B_loc * ids_per_ex * emb_dim * F32 * 3  # fwd read + bwd add
        # dense AdamW touches the WHOLE table
        P = cfg.param_count()
        P_loc = P / tp  # tables split by rows; the small rest replicated
        opt = Cost(12 * P_loc, 13 * P_loc * F32,
                   _ring(dp, P_loc * F32, reduce=True))
        act = B_loc * per_ex / (2 * 256) * BF16  # rough: 256-wide reuse
        return Cost(3 * B_loc * per_ex, gather + act, 0.0) + opt

    if step == "serve":
        B_loc = dims["batch"] / dp
        C = cfg.serve_candidates
        w = cfg.param_count() - (cfg.vocab_rows * d
                                 if cfg.kind != "two_tower" else 0)
        gather = B_loc * (cfg.seq_len + 1 + C) * d * BF16
        return Cost(B_loc * per_ex + 2 * B_loc * C * d,
                    gather + w * BF16 / n_chips, 0.0)

    # retrieval: decode the candidates + embed + score, over the whole mesh
    C_loc = dims["n_candidates"] / n_chips
    if cfg.kind == "two_tower":
        dims_i = (cfg.id_dim,) + cfg.mlp_dims
        f = (2 * sum(a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
             + 2 * cfg.mlp_dims[-1])
        emb_read = C_loc * cfg.id_dim * BF16
    elif cfg.kind == "bst":
        f = per_ex
        emb_read = C_loc * (cfg.seq_len + 1) * d * BF16
    else:
        f = 2 * d
        emb_read = C_loc * d * BF16
    # dot-product heads run the fused dot_score epilogue (ids and scores
    # out, no decoded-id round trip); tower and ranker heads (two_tower,
    # bst) decode, then score
    fused = cfg.kind in ("sasrec", "bert4rec")
    decode = decode_cost(C_loc, fused=fused)
    topk_wire = _ring(n_chips, 100 * 8 * 2)  # top-k exchange, negligible
    return decode + Cost(C_loc * f, emb_read + C_loc * F32, topk_wire)


def cell_cost(cell, *, n_chips: int, dp: int, tp: int = 16) -> Cost:
    """The modelled cost of one ``registry.build_cell`` cell a device."""
    if cell.family == "lm":
        return lm_cost(cell.cfg, cell.shape, n_chips=n_chips, dp=dp, tp=tp,
                       assembly=getattr(cell, "assembly", None))
    fn = {"gnn": gnn_cost, "recsys": recsys_cost}[cell.family]
    return fn(cell.cfg, cell.shape, n_chips=n_chips, dp=dp, tp=tp)
