"""The port's vbyte encoders give byte-identical operands to the reference's
``repro.core.vbyte.encode`` (blocked, ragged, wrap, metadata, sizes), and the
golden byte vectors replay through the port."""
import numpy as np
import pytest

import jax  # noqa: F401  (the reference runs on the CPU backend)

from repro.core.vbyte import encode as R
from repro_torch.core.vbyte import encode as T
from repro_torch.core.vbyte import ref as Tref

from conftest import BOUNDARY_VALUES, sorted_u32_cases, u32_cases
from test_golden_vectors import VBYTE_GOLDEN


def _same_encoding(r, t, msg):
    np.testing.assert_array_equal(r.payload, t.payload, err_msg=msg)
    np.testing.assert_array_equal(r.counts, t.counts, err_msg=msg)
    np.testing.assert_array_equal(r.bases, t.bases, err_msg=msg)
    assert r.payload.dtype == t.payload.dtype == np.uint8
    assert (r.n, r.block_size, r.differential, r.ragged) == \
        (t.n, t.block_size, t.differential, t.ragged), msg
    assert r.payload_bytes == t.payload_bytes, msg
    assert r.bits_per_int == t.bits_per_int, msg
    assert r.device_bytes == t.device_bytes, msg


@pytest.mark.parametrize("block_size", [8, 128])
@pytest.mark.parametrize("stride_multiple", [1, 128])
def test_blocked_encode_byte_identical(block_size, stride_multiple):
    for case, vals in u32_cases(n_cases=10, max_len=300, seed=11):
        kw = dict(block_size=block_size, stride_multiple=stride_multiple)
        _same_encoding(R.encode_blocked(vals, **kw), T.encode_blocked(vals, **kw),
                       f"{case} raw")
    for case, vals in sorted_u32_cases(n_cases=10, max_len=300, seed=12):
        kw = dict(block_size=block_size, stride_multiple=stride_multiple,
                  differential=True)
        _same_encoding(R.encode_blocked(vals, **kw), T.encode_blocked(vals, **kw),
                       f"{case} differential")


def test_prepare_blocked_and_skip_table():
    for case, vals in sorted_u32_cases(n_cases=6, max_len=400, seed=13):
        r = R.prepare_blocked(vals, block_size=32, differential=True)
        t = T.prepare_blocked(vals, block_size=32, differential=True)
        for name in ("values", "enc_values", "bases", "counts"):
            np.testing.assert_array_equal(getattr(r, name), getattr(t, name),
                                          err_msg=f"{case} {name}")
        for a, b in zip(r.skip_table(), t.skip_table()):
            np.testing.assert_array_equal(a, b, err_msg=case)
        _same_encoding(R.encode_blocked(meta=r), T.encode_blocked(meta=t), case)


@pytest.mark.parametrize("differential", [False, True])
def test_ragged_encode_byte_identical(differential):
    rng = np.random.default_rng(5)
    lists = [np.sort(rng.integers(0, 2**31, size=int(rng.integers(0, 33))))
             for _ in range(17)] + [[], np.array([2**31 - 1])]
    kw = dict(block_size=32, differential=differential)
    _same_encoding(R.encode_ragged_blocked(lists, **kw),
                   T.encode_ragged_blocked(lists, **kw), "ragged")
    with pytest.raises(ValueError, match="block_size"):
        T.encode_ragged_blocked([np.arange(40)], block_size=32)


def test_boundary_values_stream_and_lengths():
    np.testing.assert_array_equal(R.encode_stream(BOUNDARY_VALUES),
                                  T.encode_stream(BOUNDARY_VALUES))
    np.testing.assert_array_equal(R.vbyte_lengths(BOUNDARY_VALUES),
                                  T.vbyte_lengths(BOUNDARY_VALUES))


@pytest.mark.parametrize("value,expected", VBYTE_GOLDEN)
def test_golden_vectors_replay(value, expected):
    assert T.encode_stream(np.array([value], np.uint64)).tolist() == expected
    assert Tref.decode_stream_scalar(np.array(expected, np.uint8), 1)[0] == value


def test_validate_u32_and_wrap():
    bad = [np.array([-3, 5], np.int64), np.array([2**32], np.uint64),
           np.array([1.5, 2.0])]
    for a in bad:
        with pytest.raises(ValueError):
            R.validate_u32(a)
        with pytest.raises(ValueError):
            T.validate_u32(a)
        np.testing.assert_array_equal(R.validate_u32(a, wrap=True),
                                      T.validate_u32(a, wrap=True))
    wrapped = np.array([-1, -2**31, 2**32 + 7, 3], np.int64)
    _same_encoding(R.encode_blocked(wrapped, block_size=8, wrap=True),
                   T.encode_blocked(wrapped, block_size=8, wrap=True), "wrap")
    with pytest.raises(ValueError, match="non-decreasing"):
        T.delta_encode(np.array([3, 1], np.uint64))
