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
