"""The port's decoders — the plain version of kernel 1
(``core.vbyte.masked``), the kernel wrapper on CPU tensors, the gather-lowered
``ref`` path and ``CompressedIntArray.decode`` — match the reference's
decoders and the scalar oracle bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import CompressedIntArray as RArr
from repro.core.vbyte import masked as Rmasked
from repro.core.vbyte import ref as Rref
from repro.kernels.vbyte_decode import vbyte_decode_blocked as R_kernel
from repro_torch.core import CompressedIntArray as TArr
from repro_torch.core.vbyte import masked as Tmasked
from repro_torch.kernels.vbyte_decode import dispatch as Tdispatch
from repro_torch.kernels.vbyte_decode import ops as Tops
from repro_torch.kernels.vbyte_decode.kernel import vbyte_decode_blocked_cuda
from repro_torch.kernels.vbyte_decode.ref import vbyte_decode_blocked_ref

from conftest import make_valid_stream, sorted_u32_cases, u32_cases
from torch_parity import CPU, assert_same

PORT_PLANS = ("torch", "ref", "cuda")


def _port_decoders(payload, counts, bases, B, differential):
    """Every port decoder on the same host operands."""
    p = torch.as_tensor(payload)
    c = torch.as_tensor(np.asarray(counts, np.int32))
    b = torch.as_tensor(np.asarray(bases, np.uint32).view(np.int32))
    kw = dict(block_size=B, differential=differential)
    return {"masked": Tmasked.decode_blocked(p, c, b, **kw),
            "ref": vbyte_decode_blocked_ref(p, c, b, **kw),
            "wrapper": vbyte_decode_blocked_cuda(p, c, b, **kw),
            "ops": Tops.vbyte_decode_blocked(p, c[:, None], b[:, None], **kw)}


def _check_all(payload, counts, bases, B, differential, *, msg="",
               with_ref=True):
    oracle = Rref.decode_blocked_scalar(payload, counts, bases, B,
                                        differential=differential)
    jnp_out = Rmasked.decode_blocked(jnp.asarray(payload), jnp.asarray(counts),
                                     jnp.asarray(bases), block_size=B,
                                     differential=differential)
    assert_same(oracle, jnp_out, msg)
    for name, out in _port_decoders(payload, counts, bases, B,
                                    differential).items():
        if name == "ref" and not with_ref:
            continue
        assert out.dtype == torch.int32 and out.shape == (len(counts), B)
        assert_same(oracle, out, f"{msg} {name}")
    return oracle


@pytest.mark.parametrize("B", [8, 32, 128])
@pytest.mark.parametrize("differential", [False, True])
def test_decoders_match_reference_and_oracle(B, differential):
    cases = (sorted_u32_cases(n_cases=8, max_len=400, seed=3) if differential
             else u32_cases(n_cases=8, max_len=400, seed=4))
    for case, vals in cases:
        enc = RArr.encode(vals, block_size=B, differential=differential)
        _check_all(np.asarray(enc.payload), np.asarray(enc.counts),
                   np.asarray(enc.bases), B, differential, msg=case)


@pytest.mark.parametrize("differential", [False, True])
def test_byte_length_regimes_and_count0_blocks(differential):
    """Every 1..5-byte length, count-0 blocks between full ones, and random
    bases (the differential carry wraps mod 2^32)."""
    rng = np.random.default_rng(8)
    lists = []
    for i in range(24):
        if i % 5 == 0:
            lists.append([])
            continue
        bits = [7, 14, 21, 28, 32][i % 5]
        n = int(rng.integers(1, 33))
        lists.append(rng.integers(0, 2**bits, size=n, dtype=np.uint64))
    enc = RArr.encode_ragged(lists, block_size=32)
    bases = rng.integers(0, 2**32, size=len(lists), dtype=np.uint64
                         ).astype(np.uint32)
    _check_all(np.asarray(enc.payload), np.asarray(enc.counts), bases, 32,
               differential, msg="regimes")


def test_overlong_runs_sum_like_the_reference():
    """Garbage payloads (runs of > 5 continuation bytes, counts past the real
    integers): the masked decoders add contributions exactly like the
    reference's scatter-sum."""
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, size=(16, 64), dtype=np.uint8)
    payload[3, :12] = 0xFF  # a 12-byte continuation run
    counts = rng.integers(0, 33, size=16).astype(np.int32)
    bases = rng.integers(0, 2**32, size=16, dtype=np.uint64).astype(np.uint32)
    for differential in (False, True):
        ref = Rmasked.decode_blocked(jnp.asarray(payload), jnp.asarray(counts),
                                     jnp.asarray(bases), block_size=32,
                                     differential=differential)
        for name, out in _port_decoders(payload, counts, bases, 32,
                                        differential).items():
            if name != "ref":  # the gather decoder reads ≤ 5 bytes an int
                assert_same(ref, out, f"garbage {name} {differential}")


def test_counts_past_block_size_follow_the_pallas_kernel():
    """counts > B is out of contract. The reference's jnp decoder routes the
    overflow bytes into slot B-1 while its Pallas kernel drops them; the
    port (kernel and plain version alike) follows the Pallas kernel."""
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    counts = np.array([20, 30, 17, 40, 16, 0, 5, 33], np.int32)
    bases = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    for differential in (False, True):
        ref = R_kernel(jnp.asarray(payload), jnp.asarray(counts),
                       jnp.asarray(bases), block_size=16,
                       differential=differential)
        outs = _port_decoders(payload, counts, bases, 16, differential)
        for name in ("masked", "wrapper", "ops"):
            assert_same(ref, outs[name], f"counts>B {name} {differential}")


def test_golden_layouts():
    # terminator look-alike padding; a count-0 row with garbage bytes
    payload = np.zeros((2, 16), np.uint8)
    payload[0, :3] = [0x85, 0x01, 0x03]
    payload[1, :4] = [0x99, 0xAA, 0x7F, 0x05]
    out = _check_all(payload, np.array([2, 0], np.int32),
                     np.zeros(2, np.uint32), 8, False)
    assert out[0, :2].tolist() == [133, 3] and not out[1].any()
    # differential wrap: base 2^32-2, gaps [1, 5] -> [2^32-1, 4]
    payload = np.zeros((1, 16), np.uint8)
    payload[0, :2] = [0x01, 0x05]
    out = _check_all(payload, np.array([2], np.int32),
                     np.array([2**32 - 2], np.uint32), 8, True)
    assert out[0, :2].tolist() == [2**32 - 1, 4]
    # five-byte wrap: 2^35-1 ≡ 2^32-1 (mod 2^32)
    payload = np.zeros((1, 16), np.uint8)
    payload[0, :5] = [0xFF, 0xFF, 0xFF, 0xFF, 0x7F]
    out = _check_all(payload, np.array([1], np.int32), np.zeros(1, np.uint32),
                     8, False)
    assert out[0, 0] == 2**32 - 1


def test_pallas_kernel_parity_tiny():
    """A handful of tiny cases against the Pallas kernel itself (interpret
    mode on the CPU, as the reference's own tests run it)."""
    rng = np.random.default_rng(10)
    vals = make_valid_stream(rng, 40)
    for differential in (False, True):
        v = np.sort(vals) if differential else vals
        enc = RArr.encode(v, block_size=16, differential=differential)
        ref = R_kernel(jnp.asarray(enc.payload), jnp.asarray(enc.counts),
                       jnp.asarray(enc.bases), block_size=16,
                       differential=differential)
        for name, out in _port_decoders(
                np.asarray(enc.payload), np.asarray(enc.counts),
                np.asarray(enc.bases), 16, differential).items():
            assert_same(ref, out, f"pallas {name}")


@pytest.mark.parametrize("differential", [False, True])
def test_compressed_array_decode_and_take_blocks(differential):
    rng = np.random.default_rng(12)
    vals = np.sort(rng.integers(0, 2**31, size=300)).astype(np.uint64)
    if not differential:
        rng.shuffle(vals)
    r = RArr.encode(vals, block_size=32, differential=differential)
    t = TArr.encode(vals, block_size=32, differential=differential,
                    device="cpu")
    for plan in PORT_PLANS:
        np.testing.assert_array_equal(t.decode(plan=plan), vals.astype(np.uint32))
        assert_same(r.decode_blocked(plan="jnp"), t.decode_blocked(plan=plan),
                    plan)
    np.testing.assert_array_equal(t.decode_scalar_oracle(),
                                  r.decode_scalar_oracle())
    assert t.bits_per_int == r.bits_per_int
    assert t.compression_ratio == r.compression_ratio
    # non-contiguous gather: the partial last block lands before full ones
    rows = [9, 2, 5, 0]
    for pad_to in (None, 8):
        rs = r.take_blocks(rows, pad_to=pad_to)
        ts = t.take_blocks(rows, pad_to=pad_to)
        assert ts.n == rs.n and ts.n_blocks == rs.n_blocks
        np.testing.assert_array_equal(ts.counts_host, np.asarray(rs.counts))
        for plan in PORT_PLANS:
            np.testing.assert_array_equal(ts.decode(plan=plan),
                                          rs.decode(plan="jnp"))
    ss, rs = t.slice_blocks(3, 7, pad_to=8), r.slice_blocks(3, 7, pad_to=8)
    np.testing.assert_array_equal(ss.decode(), rs.decode(plan="jnp"))
    with pytest.raises(RuntimeError, match="encoded size"):
        ss.bits_per_int


def test_empty_and_checksum_column():
    t = TArr.encode(np.zeros(0, np.uint64), device="cpu")
    assert t.n == 0 and t.n_blocks == 1 and t.decode().size == 0
    rng = np.random.default_rng(13)
    vals = np.sort(rng.integers(0, 2**31, size=90)).astype(np.uint64)
    r = RArr.encode(vals, block_size=16, differential=True, checksum=True)
    t = TArr.encode(vals, block_size=16, differential=True, checksum=True,
                    device="cpu")
    np.testing.assert_array_equal(t.checksums, np.asarray(r.checksums))
    np.testing.assert_array_equal(t.take_blocks([4, 1], pad_to=4).checksums,
                                  np.asarray(r.take_blocks([4, 1],
                                                           pad_to=4).checksums))
    lists = [[3, 9, 27], [], [2**31]]
    np.testing.assert_array_equal(
        TArr.encode_ragged(lists, block_size=8, checksum=True,
                           device="cpu").checksums,
        np.asarray(RArr.encode_ragged(lists, block_size=8,
                                      checksum=True).checksums))


def test_leaves_and_shape_contract():
    t = TArr.encode(np.arange(70, dtype=np.uint64) * 1000, block_size=32,
                    differential=True, device="cpu")
    leaves = t.leaves_numpy()
    assert leaves["payload"].dtype == np.uint8
    assert leaves["counts"].dtype == np.int32 and leaves["bases"].dtype == np.uint32
    assert t.to("cpu").device == CPU
    ops = t.device_operands()
    with pytest.raises(ValueError, match="shape"):
        Tdispatch.decode(dict(ops, counts=ops["counts"][:2]), format="vbyte",
                         block_size=32, differential=True)
    with pytest.raises(ValueError, match="required"):
        Tdispatch.decode(ops)
    with pytest.raises(ValueError, match="payload must be uint8"):
        vbyte_decode_blocked_cuda(ops["payload"].to(torch.int32), ops["counts"],
                                  ops["bases"], block_size=32,
                                  differential=True)
    with pytest.raises(ValueError, match="unknown plan"):
        t.decode(plan="pallas")
    # the other two formats are ported: they encode and decode exactly as
    # the reference does, and the vbyte-only 'ref' path refuses them as the
    # reference's does
    vals = np.arange(5, dtype=np.uint64) * 70001
    s = TArr.encode(vals, format="streamvbyte", device="cpu")
    assert_same(RArr.encode(vals, format="streamvbyte").decode_blocked(
        plan="jnp"), s.decode_blocked())
    r = RArr.encode(np.arange(70, dtype=np.uint64) * 1000, format="binpack",
                    block_size=32, differential=True)
    b_ops = {k: torch.as_tensor(np.array(v))
             for k, v in r.device_operands().items()}
    b_ops["bases"] = b_ops["bases"].view(torch.int32)
    assert_same(r.decode_blocked(plan="jnp"),
                Tdispatch.decode(b_ops, format="binpack", block_size=32,
                                 differential=True))
    with pytest.raises(ValueError, match="only exists"):
        Tdispatch.decode(b_ops, format="binpack", block_size=32,
                         differential=True, plan="ref")
