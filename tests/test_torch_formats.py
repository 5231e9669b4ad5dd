"""The port's Stream-VByte and binpack stack against the reference, bit for
bit: the encoders (byte-identical operands, blocked and ragged,
differential both ways), the golden vectors, the plain versions of kernels
3 and 4 (``stream_masked``/``binpack_masked``, and the kernel wrappers on
CPU tensors) against the reference's jnp decoders and its Pallas kernels
in interpret mode, and ``CompressedIntArray`` in both formats."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import CompressedIntArray as RArr
from repro.core.vbyte import binpack as Rbpk
from repro.core.vbyte import binpack_masked as Rbpkm
from repro.core.vbyte import stream_masked as Rsvbm
from repro.core.vbyte import stream_vbyte as Rsvb
from repro.kernels.vbyte_decode import binpack_decode_blocked as R_bp_kernel
from repro.kernels.vbyte_decode import stream_vbyte_decode_blocked as R_svb_kernel
from repro_torch.core import CompressedIntArray as TArr
from repro_torch.core.vbyte import binpack as Tbpk
from repro_torch.core.vbyte import binpack_masked as Tbpkm
from repro_torch.core.vbyte import stream_masked as Tsvbm
from repro_torch.core.vbyte import stream_vbyte as Tsvb
from repro_torch.kernels.vbyte_decode import dispatch as Tdispatch
from repro_torch.kernels.vbyte_decode import ops as Tops
from repro_torch.kernels.vbyte_decode.binpack_kernel import binpack_decode_blocked_cuda
from repro_torch.kernels.vbyte_decode.stream_kernel import stream_decode_blocked_cuda

from conftest import BOUNDARY_VALUES, sorted_u32_cases, u32_cases
from test_golden_vectors import BINPACK_GOLDEN, SVB_GOLDEN
from torch_parity import assert_same

ENCODERS = {"streamvbyte": (Rsvb, Tsvb), "binpack": (Rbpk, Tbpk)}
LEAVES = {"streamvbyte": ("control", "data"), "binpack": ("widths", "data")}


def _same_encoding(fmt, r, t, msg):
    for name in LEAVES[fmt] + ("counts", "bases"):
        a, b = getattr(r, name), getattr(t, name)
        assert a.dtype == b.dtype, f"{msg} {name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")
    assert (r.n, r.block_size, r.differential, r.ragged) == \
        (t.n, t.block_size, t.differential, t.ragged), msg
    assert r.payload_bytes == t.payload_bytes, msg
    assert r.bits_per_int == t.bits_per_int, msg
    assert r.device_bytes == t.device_bytes, msg


@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
@pytest.mark.parametrize("block_size", [8, 128])
@pytest.mark.parametrize("differential", [False, True])
def test_blocked_encode_byte_identical(fmt, block_size, differential):
    R, T = ENCODERS[fmt]
    cases = (sorted_u32_cases(n_cases=8, max_len=300, seed=31) if differential
             else u32_cases(n_cases=8, max_len=300, seed=32))
    for case, vals in cases:
        for sm in (1, 128):
            kw = dict(block_size=block_size, differential=differential,
                      stride_multiple=sm)
            _same_encoding(fmt, R.encode_blocked(vals, **kw),
                           T.encode_blocked(vals, **kw), f"{case} sm={sm}")


@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
@pytest.mark.parametrize("differential", [False, True])
def test_ragged_encode_byte_identical(fmt, differential):
    R, T = ENCODERS[fmt]
    rng = np.random.default_rng(33)
    lists = [np.sort(rng.integers(0, 2**31, size=int(rng.integers(0, 33))))
             for _ in range(17)] + [[], np.array([2**31 - 1])]
    kw = dict(block_size=32, differential=differential)
    _same_encoding(fmt, R.encode_ragged_blocked(lists, **kw),
                   T.encode_ragged_blocked(lists, **kw), "ragged")


def test_svb_streams_lengths_and_wrap():
    np.testing.assert_array_equal(Rsvb.svb_lengths(BOUNDARY_VALUES),
                                  Tsvb.svb_lengths(BOUNDARY_VALUES))
    for a, b in zip(Rsvb.encode_stream(BOUNDARY_VALUES),
                    Tsvb.encode_stream(BOUNDARY_VALUES)):
        np.testing.assert_array_equal(a, b)
    codes = np.random.default_rng(34).integers(0, 4, 40).astype(np.uint8)
    np.testing.assert_array_equal(Tsvb.pack_control(codes),
                                  Rsvb.pack_control(codes))
    np.testing.assert_array_equal(Tsvb.unpack_control(Tsvb.pack_control(codes),
                                                      37), codes[:37])
    wrapped = np.array([-1, -2**31, 2**32 + 7, 3], np.int64)
    _same_encoding("streamvbyte",
                   Rsvb.encode_blocked(wrapped, block_size=8, wrap=True),
                   Tsvb.encode_blocked(wrapped, block_size=8, wrap=True),
                   "wrap")
    np.testing.assert_array_equal(Tbpk.bit_widths(BOUNDARY_VALUES),
                                  Rbpk.bit_widths(BOUNDARY_VALUES))


@pytest.mark.parametrize("value,code,expected", SVB_GOLDEN)
def test_svb_golden_vectors_replay(value, code, expected):
    control, data = Tsvb.encode_stream(np.array([value], np.uint64))
    assert control.tolist() == [code] and data.tolist() == expected
    assert Tsvb.decode_stream_scalar(control, data, 1)[0] == value


@pytest.mark.parametrize("width,values,expected", BINPACK_GOLDEN)
def test_binpack_golden_vectors_replay(width, values, expected):
    vals = np.array(values, np.uint64).reshape(1, -1)
    assert int(Tbpk.block_widths(vals, np.array([len(values)]))[0]) == width
    packed = Tbpk.pack_rows(vals, width)
    assert packed[0].tolist() == expected
    out = Tbpk.decode_block_scalar(np.pad(packed[0], (0, 8)), width,
                                   len(values))
    np.testing.assert_array_equal(out, np.array(values, np.uint64))


# ---------------------------------------------------------------------------
# plain versions of kernels 3 and 4
# ---------------------------------------------------------------------------
def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype == "bits":
        a = a.astype(np.uint32).view(np.int32)
    elif dtype is not None:
        a = a.astype(dtype)
    return torch.as_tensor(np.ascontiguousarray(a))


def _svb_port(control, data, counts, bases, B, differential):
    c, d, n, b = _t(control), _t(data), _t(counts, np.int32), _t(bases, "bits")
    kw = dict(block_size=B, differential=differential)
    return {"masked": Tsvbm.decode_blocked(c, d, n, b, **kw),
            "wrapper": stream_decode_blocked_cuda(c, d, n, b, **kw),
            "ops": Tops.stream_vbyte_decode_blocked(c, d, n[:, None],
                                                    b[:, None], **kw)}


def _bp_port(widths, data, counts, bases, B, differential):
    w = _t(np.asarray(widths, np.uint8).reshape(-1, 1))
    d, n, b = _t(data), _t(counts, np.int32), _t(bases, "bits")
    kw = dict(block_size=B, differential=differential)
    return {"masked": Tbpkm.decode_blocked(w, d, n, b, **kw),
            "wrapper": binpack_decode_blocked_cuda(w, d, n, b, **kw),
            "ops": Tops.binpack_decode_blocked(w[:, 0], d, n[:, None],
                                               b[:, None], **kw)}


def _check_svb(control, data, counts, bases, B, differential, msg="",
               oracle=True):
    ref = Rsvbm.decode_blocked(jnp.asarray(control), jnp.asarray(data),
                               jnp.asarray(counts), jnp.asarray(bases),
                               block_size=B, differential=differential)
    if oracle:
        assert_same(Rsvb.decode_blocked_scalar(
            control, data, counts, bases, B, differential=differential), ref)
    for name, out in _svb_port(control, data, counts, bases, B,
                               differential).items():
        assert out.dtype == torch.int32 and out.shape == (len(counts), B)
        assert_same(ref, out, f"{msg} {name}")


def _check_bp(widths, data, counts, bases, B, differential, msg="",
              oracle=True):
    ref = Rbpkm.decode_blocked(jnp.asarray(widths), jnp.asarray(data),
                               jnp.asarray(counts), jnp.asarray(bases),
                               block_size=B, differential=differential)
    if oracle:
        assert_same(Rbpk.decode_blocked_scalar(
            widths, data, counts, bases, B, differential=differential), ref)
    for name, out in _bp_port(widths, data, counts, bases, B,
                              differential).items():
        assert out.dtype == torch.int32 and out.shape == (len(counts), B)
        assert_same(ref, out, f"{msg} {name}")


@pytest.mark.parametrize("B", [8, 32, 128])
@pytest.mark.parametrize("differential", [False, True])
def test_plain_decoders_match_reference(B, differential):
    cases = (sorted_u32_cases(n_cases=6, max_len=400, seed=35) if differential
             else u32_cases(n_cases=6, max_len=400, seed=36))
    for case, vals in cases:
        s = Rsvb.encode_blocked(vals, block_size=B, differential=differential)
        _check_svb(s.control, s.data, s.counts, s.bases, B, differential,
                   case)
        p = Rbpk.encode_blocked(vals, block_size=B, differential=differential)
        _check_bp(p.widths, p.data, p.counts, p.bases, B, differential, case)


@pytest.mark.parametrize("differential", [False, True])
def test_ragged_count0_blocks_every_length_and_width(differential):
    """Count-0 blocks between ragged ones, every svb byte length and every
    binpack width 0..32, random bases (the carry wraps mod 2^32)."""
    rng = np.random.default_rng(37)
    lists = []
    for i in range(40):
        if i % 6 == 0:
            lists.append([])
            continue
        bits = i % 33
        n = int(rng.integers(1, 33))
        lists.append(rng.integers(0, 2**bits, size=n, dtype=np.uint64))
    bases = rng.integers(0, 2**32, size=len(lists), dtype=np.uint64
                         ).astype(np.uint32)
    s = Rsvb.encode_ragged_blocked(lists, block_size=32)
    _check_svb(s.control, s.data, s.counts, bases, 32, differential, "svb")
    p = Rbpk.encode_ragged_blocked(lists, block_size=32)
    assert set(np.unique(p.widths)) >= {0, 32}
    _check_bp(p.widths, p.data, p.counts, bases, 32, differential, "binpack")


def test_goldens_through_the_port():
    """The hand-written layouts of tests/test_golden_vectors.py: svb
    zero-code padding and control order, binpack width 32, the ragged tail
    plus a count-0 garbage row, and both differential wraparounds."""
    control = np.zeros((2, 2), np.uint8)
    control[0, 0] = 0xE4
    data = np.zeros((2, 16), np.uint8)
    data[0, :10] = [0x01, 0x2C, 0x01, 0x70, 0x11, 0x01, 0xFF, 0xFF, 0xFF, 0xFF]
    data[1, :3] = [0xDE, 0xAD, 0xBE]
    out = _svb_port(control, data, np.array([4, 0]), np.zeros(2), 8,
                    False)["wrapper"].numpy().view(np.uint32)
    assert out[0, :4].tolist() == [1, 300, 70000, 2**32 - 1]
    assert not out[0, 4:].any() and not out[1].any()
    data = np.zeros((1, 16), np.uint8)
    data[0, :2] = [0x01, 0x05]
    out = _svb_port(np.zeros((1, 2), np.uint8), data, np.array([2]),
                    np.array([2**32 - 2]), 8, True)["masked"]
    assert out.numpy().view(np.uint32)[0, :2].tolist() == [2**32 - 1, 4]

    data = np.zeros((3, 16), np.uint8)
    data[0, :3] = [0x81, 0x3F, 0x10]
    data[1, :4] = [0xDE, 0xAD, 0xBE, 0xEF]
    out = _bp_port(np.array([[7], [5], [0]]), data, np.array([3, 0, 4]),
                   np.zeros(3), 8, False)["wrapper"].numpy()
    assert out[0, :3].tolist() == [1, 127, 64] and not out[1:].any()
    data = np.zeros((1, 128), np.uint8)
    data[0, :8] = [0xFF, 0xFF, 0xFF, 0xFF, 0xEF, 0xBE, 0xAD, 0xDE]
    out = _bp_port(np.array([[32]]), data, np.array([2]), np.zeros(1), 8,
                   False)["ops"].numpy().view(np.uint32)
    assert out[0, :2].tolist() == [2**32 - 1, 0xDEADBEEF]
    data = np.zeros((1, 16), np.uint8)
    data[0, 0] = 0x29
    out = _bp_port(np.array([[3]]), data, np.array([2]),
                   np.array([2**32 - 2]), 8, True)["masked"]
    assert out.numpy().view(np.uint32)[0, :2].tolist() == [2**32 - 1, 4]


def test_pallas_kernels_parity_tiny():
    """Kernels 3 and 4 against the reference's Pallas kernels themselves
    (interpret mode), on valid blocks and on the garbage the Pallas
    kernels define: svb rows whose lengths run past the row end S (those
    bytes add nothing), binpack widths past 32 and past the row (reads
    clamped to S-1, window bytes past S read 0), counts past B."""
    rng = np.random.default_rng(38)
    vals = np.sort(rng.integers(0, 2**31, 50)).astype(np.uint64)
    for differential in (False, True):
        s = Rsvb.encode_blocked(vals, block_size=16, differential=differential)
        p = Rbpk.encode_blocked(vals, block_size=16, differential=differential)
        ref = R_svb_kernel(jnp.asarray(s.control), jnp.asarray(s.data),
                           jnp.asarray(s.counts), jnp.asarray(s.bases),
                           block_size=16, differential=differential)
        for name, out in _svb_port(s.control, s.data, s.counts, s.bases, 16,
                                   differential).items():
            assert_same(ref, out, f"svb pallas {name}")
        ref = R_bp_kernel(jnp.asarray(p.widths), jnp.asarray(p.data),
                          jnp.asarray(p.counts), jnp.asarray(p.bases),
                          block_size=16, differential=differential)
        for name, out in _bp_port(p.widths, p.data, p.counts, p.bases, 16,
                                  differential).items():
            assert_same(ref, out, f"binpack pallas {name}")

    # garbage: all-ones control bytes (length 4 each) over a 20-byte row
    nb, B, S = 8, 32, 20
    control = rng.integers(0, 256, (nb, B // 4), dtype=np.uint8)
    control[0] = 0xFF
    data = rng.integers(1, 256, (nb, S), dtype=np.uint8)
    counts = np.array([32, 5, 0, 32, 40, 17, 31, 9], np.int32)
    widths = rng.integers(0, 256, (nb, 1), dtype=np.uint8)
    widths[:3, 0] = [0, 32, 33]
    bases = rng.integers(0, 2**32, nb, dtype=np.uint64).astype(np.uint32)
    for differential in (False, True):
        ref = R_svb_kernel(jnp.asarray(control), jnp.asarray(data),
                           jnp.asarray(counts), jnp.asarray(bases),
                           block_size=B, differential=differential)
        for name, out in _svb_port(control, data, counts, bases, B,
                                   differential).items():
            assert_same(ref, out, f"svb garbage {name} {differential}")
        ref = R_bp_kernel(jnp.asarray(widths), jnp.asarray(data),
                          jnp.asarray(counts), jnp.asarray(bases),
                          block_size=B, differential=differential)
        for name, out in _bp_port(widths, data, counts, bases, B,
                                  differential).items():
            assert_same(ref, out, f"binpack garbage {name} {differential}")


@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
@pytest.mark.parametrize("differential", [False, True])
def test_compressed_array_formats(fmt, differential):
    rng = np.random.default_rng(39)
    vals = np.sort(rng.integers(0, 2**31, size=300)).astype(np.uint64)
    if not differential:
        rng.shuffle(vals)
    r = RArr.encode(vals, format=fmt, block_size=32,
                    differential=differential, checksum=True)
    t = TArr.encode(vals, format=fmt, block_size=32,
                    differential=differential, checksum=True, device="cpu")
    assert t.format == fmt and t.payload is None
    leaves = t.leaves_numpy()
    assert sorted(leaves) == sorted(LEAVES[fmt] + ("counts", "bases"))
    for name, leaf in leaves.items():
        np.testing.assert_array_equal(leaf, np.asarray(getattr(r, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t.checksums, np.asarray(r.checksums))
    assert (t.bits_per_int, t.compression_ratio) == \
        (r.bits_per_int, r.compression_ratio)
    for plan in ("auto", "torch", "cuda"):
        np.testing.assert_array_equal(t.decode(plan=plan),
                                      vals.astype(np.uint32))
    np.testing.assert_array_equal(t.decode_scalar_oracle(),
                                  r.decode_scalar_oracle())
    with pytest.raises(ValueError, match="only exists"):
        t.decode(plan="ref")
    rows = [9, 2, 5, 0]
    for pad_to in (None, 8):
        rs, ts = r.take_blocks(rows, pad_to=pad_to), t.take_blocks(
            rows, pad_to=pad_to)
        assert (ts.n, ts.n_blocks) == (rs.n, rs.n_blocks)
        np.testing.assert_array_equal(ts.checksums, np.asarray(rs.checksums))
        for name, leaf in ts.leaves_numpy().items():
            np.testing.assert_array_equal(leaf, np.asarray(getattr(rs, name)))
        np.testing.assert_array_equal(ts.decode(), rs.decode(plan="jnp"))
    np.testing.assert_array_equal(t.slice_blocks(3, 7, pad_to=8).decode(),
                                  r.slice_blocks(3, 7, pad_to=8).decode(
                                      plan="jnp"))
    lists = [[3, 9, 27], [], [2**31]]
    r = RArr.encode_ragged(lists, format=fmt, block_size=8, checksum=True)
    t = TArr.encode_ragged(lists, format=fmt, block_size=8, checksum=True,
                           device="cpu")
    np.testing.assert_array_equal(t.checksums, np.asarray(r.checksums))
    np.testing.assert_array_equal(t.decode(), r.decode(plan="jnp"))
    ops = {k: torch.as_tensor(v) for k, v in t.leaves_numpy().items()}
    ops["bases"] = ops["bases"].view(torch.int32)
    again = TArr.from_operands(ops, format=fmt, block_size=8, device="cpu")
    np.testing.assert_array_equal(again.decode(), t.decode())
    assert again.n == t.n
    with pytest.raises(ValueError, match="missing"):
        TArr.from_operands({"counts": ops["counts"], "bases": ops["bases"]},
                           format=fmt, device="cpu")


def test_operand_contract_errors():
    t = TArr.encode(np.arange(64, dtype=np.uint64), format="streamvbyte",
                    block_size=32, device="cpu")
    ops = t.device_operands()
    with pytest.raises(ValueError, match="control width"):
        stream_decode_blocked_cuda(ops["control"][:, :4], ops["data"],
                                   ops["counts"], ops["bases"], block_size=32,
                                   differential=False)
    with pytest.raises(ValueError, match="multiple of 4"):
        stream_decode_blocked_cuda(ops["control"], ops["data"], ops["counts"],
                                   ops["bases"], block_size=30,
                                   differential=False)
    b = TArr.encode(np.arange(64, dtype=np.uint64), format="binpack",
                    block_size=32, device="cpu").device_operands()
    with pytest.raises(ValueError, match="widths must be uint8"):
        binpack_decode_blocked_cuda(b["widths"][:, 0], b["data"], b["counts"],
                                    b["bases"], block_size=32,
                                    differential=False)
    # dispatch takes the width column as [n_blocks] too, as the reference
    out = Tdispatch.decode(dict(b, widths=b["widths"][:, 0]), format="binpack",
                           block_size=32, differential=False)
    assert_same(Tdispatch.decode(b, format="binpack", block_size=32,
                                 differential=False), out)
    with pytest.raises(ValueError, match="unknown format"):
        TArr.encode(np.arange(5), format="auto", device="cpu")
