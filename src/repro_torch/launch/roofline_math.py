"""Roofline terms of a cell on one NVIDIA H100 SXM5 80GB.

The port of ``repro/launch/roofline_math.py``: the same terms
(:class:`Roofline`, :func:`make_roofline`) and the same analytic model
FLOPs (:func:`model_flops_global`), over the H100's published peaks in
place of the reference's TPU constants. The card the smoke reports is
"NVIDIA H100 80GB HBM3" at a 700 W power limit; NVIDIA's H100 datasheet
(SXM5 column) gives:

* ``PEAK_FLOPS`` — 989 TFLOP/s dense BF16 on the tensor cores (the
  sheet's 1,979 is with 2:4 sparsity, which no cell uses);
* ``HBM_BW`` — 3.35 TB/s HBM3;
* ``LINK_BW`` — 450 GB/s a direction: NVLink 4's 900 GB/s total
  bandwidth a card, half of it each way, for the wire term. Logical
  shards of one card copy within its memory instead.

These peaks assume the full 700 W; a card set below it runs slower
under load. Costs come from ``launch/cost_model.py`` (the port produces
no compiled HLO to read): ``dryrun.py`` makes one :class:`Roofline` a
cell. MODEL_FLOPS is the analytic useful compute (6·N·D dense /
6·N_active·D MoE for LM training; per-family approximations otherwise),
so MODEL_FLOPS over the modelled FLOPs shows recomputation, dispatch and
padding work.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores (H100 SXM5 datasheet)
HBM_BW = 3.35e12  # bytes/s, HBM3 (H100 SXM5 datasheet)
LINK_BW = 450e9  # bytes/s a direction: NVLink 4, 900 GB/s total (datasheet)


@dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_per_device: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The bound with perfect overlap: the largest of the three
        terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_per_device / max(self.flops_per_device, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOPs over what the tensor cores could do in the bound
        step time (≈ the projected MFU when compute-bound)."""
        return self.model_flops_per_device / (self.step_time_s * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "step_time_bound_s": self.step_time_s,
        }


def make_roofline(flops: float, bytes_: float, wire_bytes: float,
                  model_flops_per_device: float) -> Roofline:
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_ / HBM_BW,
        collective_s=wire_bytes / LINK_BW,
        flops_per_device=flops,
        bytes_per_device=bytes_,
        wire_bytes_per_device=wire_bytes,
        model_flops_per_device=model_flops_per_device,
    )


# ----------------------------------------------------------------------------
# analytic MODEL_FLOPS per cell (global; divide by devices for one's share)
# ----------------------------------------------------------------------------
def _attn_flops(cfg, S: int, B: int) -> float:
    """Useful attention matmul FLOPs (fwd): QKᵀ + PV, causal/window-aware."""
    eff = min(cfg.window, S) if cfg.window else S / 2.0
    return 4.0 * cfg.n_layers * B * cfg.n_heads * cfg.dh * S * eff


def model_flops_global(cell) -> float:
    fam, cfg, dims, step = (cell.family, cell.cfg, cell.shape.dims,
                            cell.shape.step)
    if fam == "lm":
        n_active = cfg.active_param_count()
        if step == "train":
            tokens = dims["global_batch"] * dims["seq_len"]
            f = 6.0 * n_active * tokens
            f += _attn_flops(cfg, dims["seq_len"],
                             dims["global_batch"]) * 3  # fwd+bwd
            return f
        if step == "prefill":
            tokens = dims["global_batch"] * dims["seq_len"]
            return 2.0 * n_active * tokens + _attn_flops(
                cfg, dims["seq_len"], dims["global_batch"])
        # decode: 1 token a sequence + attention over the (capped) cache
        from repro_torch.models.lm import cache_size

        B = dims["global_batch"]
        sc = cache_size(cfg, dims["seq_len"])
        att = 4.0 * cfg.n_layers * B * sc * cfg.n_heads * cfg.dh
        return 2.0 * n_active * B + att
    if fam == "gnn":
        h, L = cfg.d_hidden, cfg.n_layers
        n_nodes, n_edges = dims["n_nodes"], dims["n_edges"]
        mlp = 2 * (cfg.d_feat * h + h * h) + 2 * (L - 1) * (h * h + h * h)
        msg = 2 * L * n_edges * max(cfg.d_feat, h) / max(n_nodes, 1)
        return 3.0 * n_nodes * (mlp + msg)  # fwd+bwd
    # recsys
    per_ex = cfg.dense_flops_per_example()
    if step == "train":
        return 3.0 * dims["batch"] * per_ex
    if step == "serve":
        return float(dims["batch"]) * per_ex
    # retrieval: every candidate is embedded and scored
    C = dims["n_candidates"]
    if cfg.kind == "two_tower":
        dims_i = (cfg.id_dim,) + cfg.mlp_dims
        item_fwd = 2 * sum(a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
        return float(C) * (item_fwd + 2 * cfg.mlp_dims[-1])
    if cfg.kind == "bst":
        return float(C) * per_ex
    return float(C) * 2 * cfg.embed_dim  # dot-product scoring
