"""The port's plain decoders and plain row-aligned epilogues against the
reference's Pallas kernels (interpret mode), bit for bit, at the row
layouts that the card's staged kernels branch on: strides of 96, 97 and
256 bytes (16-byte, 1-byte and 16-byte multiples), rows placed one row into
their buffer (a view off its base), B of 52 and 128; on valid rows padded
to those strides and on garbage: random bytes, Stream-VByte control bytes
whose lengths run past the row end, binpack widths up to 255, counts below
0 and past B. ``tests/test_torch_cuda.py`` holds the kernels against these
plain versions at the same layouts on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.vbyte_decode import dispatch as Rdispatch
from repro.kernels.vbyte_decode import binpack_decode_blocked as R_bp_kernel
from repro.kernels.vbyte_decode import stream_vbyte_decode_blocked as R_svb_kernel
from repro.kernels.vbyte_decode import vbyte_decode_blocked as R_vb_kernel
from repro_torch.core.vbyte import binpack as Tbpk
from repro_torch.core.vbyte import encode as Tenc
from repro_torch.core.vbyte import stream_vbyte as Tsvb
from repro_torch.kernels.vbyte_decode import epilogues as Tepi
from repro_torch.kernels.vbyte_decode.dispatch import CUDA_DECODERS

from torch_parity import assert_same

FORMATS = ("vbyte", "streamvbyte", "binpack")
LAYOUTS = ((96, 0), (97, 1), (256, 1))  # (stride S, rows before the view)
R_KERNELS = {"vbyte": R_vb_kernel, "streamvbyte": R_svb_kernel,
             "binpack": R_bp_kernel}
ENCODERS = {"vbyte": Tenc, "streamvbyte": Tsvb, "binpack": Tbpk}
NB = 5
ROW_EPILOGUES = ("stream", "checksum", "membership_rows", "bm25_accum_rows",
                 "bm25_weighted_rows", "adjacency_rebase")


def _view(a: np.ndarray, S: int, offset: int) -> torch.Tensor:
    """``a`` padded with zero bytes to stride ``S`` and placed ``offset``
    rows into a buffer: a contiguous view that does not start at its
    buffer's base."""
    full = np.zeros((a.shape[0] + offset, S), np.uint8)
    full[offset:, :a.shape[1]] = a
    return torch.as_tensor(full)[offset:]


def _meta(rng, fmt, B):
    """Garbage control bytes (every 4th row all length 4) or widths
    (0, 32 and past 32 among them)."""
    if fmt == "streamvbyte":
        c = rng.integers(0, 256, (NB, B // 4), dtype=np.uint8)
        c[::4] = 0xFF
        return c
    w = rng.integers(0, 256, (NB, 1), dtype=np.uint8)
    w[:3, 0] = (0, 32, 33)
    return w


def _operands(rng, fmt, B, S, garbage):
    """Host leaves (the main row last), counts and bases of ``NB`` rows of
    stride ``S``: valid rows (1..min(B, 90) values of up to 5 bits, so every
    format's encoded stride fits in 96 bytes; one row empty) or garbage."""
    if garbage:
        data = rng.integers(0, 256, (NB, S), dtype=np.uint8)
        leaves = [data] if fmt == "vbyte" else [_meta(rng, fmt, B),
                                                data]
        counts = rng.integers(-2, B + 12, NB).astype(np.int32)
        counts[:2] = (-1, B + 7)
    else:
        lists = [rng.integers(0, 2**5, size=0 if i == 2 else
                              int(rng.integers(1, min(B, 90) + 1)),
                              dtype=np.uint64)
                 for i in range(NB)]
        enc = ENCODERS[fmt].encode_ragged_blocked(lists, block_size=B,
                                                  stride_multiple=1)
        names = Tepi.FORMAT_OPERANDS[fmt]
        leaves = [np.asarray(getattr(enc, k)).reshape(NB, -1) for k in names]
        assert leaves[-1].shape[1] <= S
        counts = np.asarray(enc.counts, np.int32)
    bases = rng.integers(0, 2**32, NB, dtype=np.uint64).astype(np.uint32)
    return leaves, counts, bases


def _port_leaves(leaves, S, offset):
    *meta, main = leaves
    return [torch.as_tensor(m) for m in meta] + [_view(main, S, offset)]


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("B", [52, 128])
@pytest.mark.parametrize("S,offset", LAYOUTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_decoders_at_staged_layouts_match_reference(fmt, S, offset, B,
                                                          garbage):
    """Kernels 1, 3 and 4's plain versions (through their wrappers, on CPU
    tensors) against the reference's Pallas decode kernels."""
    rng = np.random.default_rng(S + B + 7 * garbage)
    leaves, counts, bases = _operands(rng, fmt, B, S, garbage)
    r_leaves = [jnp.asarray(v) for v in leaves[:-1]] + [
        jnp.asarray(_view(leaves[-1], S, offset).numpy())]
    t_leaves = _port_leaves(leaves, S, offset)
    c = torch.as_tensor(counts)
    b = torch.as_tensor(bases.view(np.int32))
    for differential in (False, True):
        kw = dict(block_size=B, differential=differential)
        ref = R_KERNELS[fmt](*r_leaves, jnp.asarray(counts),
                             jnp.asarray(bases), **kw)
        out = CUDA_DECODERS[fmt](*t_leaves, c, b, **kw)
        assert_same(ref, out, f"{fmt} S={S} B={B} diff={differential}")


def _extras(rng, fmt, epilogue, B, S, offset, garbage):
    """Host and port extras of a row-aligned epilogue: one probe a row (some
    -1), an impact, a weight stream in the next format (garbage when the
    main rows are), an edge_base row per block."""
    probe = rng.integers(-1, 2**31, (NB, 1)).astype(np.int32)
    probe[::2, 0] = rng.integers(0, 2**5, NB)[::2]
    if epilogue in ("membership_rows",):
        return {"probe": probe}, {"probe": torch.as_tensor(probe)}
    if epilogue == "bm25_accum_rows":
        ex = {"probe": probe, "impact": np.array([[7]], np.int32)}
        return ex, {k: torch.as_tensor(v) for k, v in ex.items()}
    if epilogue == "adjacency_rebase":
        eb = rng.integers(-2**31, 2**31, (NB, B)).astype(np.int32)
        return {"edge_base": eb}, {"edge_base": torch.as_tensor(eb)}
    if epilogue == "bm25_weighted_rows":
        w_fmt = FORMATS[(FORMATS.index(fmt) + 1) % 3]
        w_leaves, _, _ = _operands(rng, w_fmt, B, S, garbage)
        names = Tepi.FORMAT_OPERANDS[w_fmt]
        ex = {"probe": probe, **{f"w_{k}": v for k, v in
                                 zip(names, w_leaves[:-1])}}
        tex = {k: torch.as_tensor(v) for k, v in ex.items()}
        ex[f"w_{names[-1]}"] = _view(w_leaves[-1], S, offset).numpy()
        tex[f"w_{names[-1]}"] = _view(w_leaves[-1], S, offset)
        return ex, tex
    return {}, {}


@pytest.mark.parametrize("epilogue", ROW_EPILOGUES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_row_epilogues_at_staged_layouts_match_reference(fmt,
                                                               epilogue):
    """Kernel 2's row-aligned epilogues (the plain version, through the
    wrapper on CPU tensors) against the reference's Pallas fused kernel,
    garbage rows at every layout, B = 128; ``bm25_weighted_rows`` with its
    weight stream in another format than the main one."""
    B = 128
    for S, offset in LAYOUTS:
        rng = np.random.default_rng(S + len(epilogue) + FORMATS.index(fmt))
        leaves, counts, bases = _operands(rng, fmt, B, S, True)
        names = Tepi.FORMAT_OPERANDS[fmt]
        ex, tex = _extras(rng, fmt, epilogue, B, S, offset, True)
        r_ops = dict(zip(names, [jnp.asarray(v) for v in leaves[:-1]] + [
            jnp.asarray(_view(leaves[-1], S, offset).numpy())]),
                     counts=jnp.asarray(counts), bases=jnp.asarray(bases))
        t_ops = dict(zip(names, _port_leaves(leaves, S, offset)),
                     counts=torch.as_tensor(counts),
                     bases=torch.as_tensor(bases.view(np.int32)))
        kw = dict(format=fmt, block_size=B, differential=True,
                  epilogue=epilogue)
        ref = Rdispatch.decode(r_ops, epilogue_operands={
            k: jnp.asarray(v) for k, v in ex.items()}, plan="kernel", **kw)
        out = Tepi.fused_decode(t_ops, tex, **kw)
        assert_same(ref, out, f"{fmt} {epilogue} S={S} offset={offset}")
