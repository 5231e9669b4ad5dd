"""Shared helpers for the port's parity tests: the JAX reference (``repro``)
and the torch port (``repro_torch``) run on the same numpy inputs, and
their integer outputs are compared bit for bit as numpy arrays."""
import numpy as np
import torch

CPU = torch.device("cpu")


def np_u32(x) -> np.ndarray:
    """A reference (jax/numpy) or port (torch) integer output as uint32
    numpy. int32 outputs carry uint32 bits and are reinterpreted, not cast."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    a = np.asarray(x)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(np.uint64).astype(np.uint32)


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def assert_same(ref, port, msg=""):
    """Every output of ``ref`` equals the matching output of ``port``."""
    ref, port = as_tuple(ref), as_tuple(port)
    assert len(ref) == len(port), msg
    for r, p in zip(ref, port):
        r, p = np_u32(r), np_u32(p)
        assert r.shape == p.shape, f"{msg}: shape {r.shape} != {p.shape}"
        np.testing.assert_array_equal(r, p, err_msg=msg)


def bf16_ulps(a, b) -> int:
    """The largest distance between ``a`` and ``b`` in bf16 steps. Both hold
    bf16 values (bf16 tensors, or float32 ones that are exact bf16)."""
    def ordinal(x):
        v = torch.as_tensor(x).to(torch.bfloat16).view(torch.int16)
        v = v.to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)

    if torch.as_tensor(a).numel() == 0:
        return 0
    return int((ordinal(a) - ordinal(b)).abs().max())


def float_close(o, r, *, bf16: bool, terms: int, s_abs, ulps: int = 1) -> bool:
    """Elementwise: ``o`` and ``r`` — two f32 sums of ``terms`` products
    taken in different orders, each rounded once (to bf16 when ``bf16``) —
    agree within ``ulps`` bf16 ulps (bf16) or rtol = atol = 1e-5 (f32), or,
    where the sum cancels towards 0, within that plus the two f32 sums'
    worst-case rounding error 2·terms·2^-24·Σ|product| (``s_abs``: the same
    sum over absolute values)."""
    of, rf = o.float(), r.float()
    diff = (of - rf).abs()
    if bf16:
        _, e = torch.frexp(torch.maximum(of.abs(), rf.abs()))
        ulp = torch.ldexp(torch.ones_like(diff), e - 8) * ulps
    else:
        ulp = 1e-5 + 1e-5 * rf.abs()
    return bool((diff <= ulp + 2.0 * terms * 2.0**-24 * s_abs.float()
                 * 1.01).all())
