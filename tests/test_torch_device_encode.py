"""The port's device-side VByte encoder (``core/vbyte/device_encode.py``),
mirroring ``tests/test_device_encode.py``: round trips through the port's
plain decoder and kernel 1's plain version, bytes equal to the port's host
encoder at equal stride, the seeded ``u32_cases``, and payload, counts and
bases bit for bit against the reference's ``encode_blocked_device``, a
decreasing differential input (gaps that wrap mod 2^32) included."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.vbyte.device_encode import encode_blocked_device as r_encode
from repro.core.vbyte.device_encode import vbyte_lengths_device as r_lengths
from repro_torch.core.vbyte import encode as host_enc
from repro_torch.core.vbyte.device_encode import (encode_blocked_device,
                                                  vbyte_lengths_device)
from repro_torch.core.vbyte.masked import decode_blocked
from repro_torch.kernels.vbyte_decode import vbyte_decode_blocked

from conftest import make_valid_stream, u32_cases
from torch_parity import np_u32


def _pad(vals, block):
    padn = (-len(vals)) % block
    return np.concatenate([vals, np.zeros(padn, vals.dtype)]), padn


def _t(vals) -> torch.Tensor:
    """uint32 values as the port's int32 bit tensor."""
    return torch.as_tensor(vals.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("n", [128, 256, 1024])
def test_device_encode_roundtrip(rng, differential, n):
    if differential:
        vals = np.sort(rng.integers(0, 2**31, size=n)).astype(np.uint64)
    else:
        vals = make_valid_stream(rng, n)
    out = encode_blocked_device(_t(vals), block_size=128, stride=640,
                                differential=differential)
    assert out["payload"].dtype == torch.uint8
    assert out["payload"].shape == (n // 128, 640)
    assert out["counts"].dtype == out["bases"].dtype == torch.int32
    dec = decode_blocked(out["payload"], out["counts"], out["bases"],
                         block_size=128, differential=differential)
    np.testing.assert_array_equal(np_u32(dec).reshape(-1)[:n], vals)
    ker = vbyte_decode_blocked(out["payload"], out["counts"], out["bases"],
                               block_size=128, differential=differential)
    assert torch.equal(ker, dec)


def test_device_encoder_matches_host_bytes(rng):
    vals = make_valid_stream(rng, 256)
    host = host_enc.encode_blocked(vals, block_size=128, differential=False,
                                   stride_multiple=640, min_stride=640)
    dev = encode_blocked_device(_t(vals), block_size=128, stride=640)
    np.testing.assert_array_equal(dev["payload"].numpy(), host.payload)
    np.testing.assert_array_equal(np_u32(dev["bases"]), host.bases)
    np.testing.assert_array_equal(dev["counts"].numpy(), host.counts)


def test_prop_device_encode_roundtrip():
    for case, vals in u32_cases(n_cases=8, max_len=200, min_len=1, seed=21):
        padded, _ = _pad(vals, 64)
        out = encode_blocked_device(_t(padded), block_size=64, stride=320)
        dec = decode_blocked(out["payload"], out["counts"], out["bases"],
                             block_size=64, differential=False)
        np.testing.assert_array_equal(np_u32(dec).reshape(-1)[:len(vals)],
                                      vals, err_msg=case)


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("kind", ["mixed", "sorted", "decreasing"])
def test_device_encode_matches_reference_bytes(rng, differential, kind):
    vals = make_valid_stream(rng, 512)
    if kind == "sorted":
        vals = np.sort(vals)
    elif kind == "decreasing":  # every differential gap wraps mod 2^32
        vals = np.sort(vals)[::-1].copy()
    ref = r_encode(jnp.asarray(vals.astype(np.uint32)), block_size=128,
                   stride=640, differential=differential)
    # the same values as int32 bits and as int64: one encoding
    for t in (_t(vals), torch.as_tensor(vals.astype(np.int64))):
        out = encode_blocked_device(t, block_size=128, stride=640,
                                    differential=differential)
        np.testing.assert_array_equal(out["payload"].numpy(),
                                      np.asarray(ref["payload"]))
        np.testing.assert_array_equal(out["counts"].numpy(),
                                      np.asarray(ref["counts"]))
        np.testing.assert_array_equal(np_u32(out["bases"]),
                                      np.asarray(ref["bases"]))
    np.testing.assert_array_equal(
        vbyte_lengths_device(_t(vals)).numpy(),
        np.asarray(r_lengths(jnp.asarray(vals.astype(np.uint32)))))


def test_device_encode_rejects_ragged_and_host_input():
    with pytest.raises(ValueError, match="multiple of block_size"):
        encode_blocked_device(torch.zeros(100, dtype=torch.int32))
    with pytest.raises(TypeError, match="tensor"):
        encode_blocked_device(np.zeros(128, np.uint32))
