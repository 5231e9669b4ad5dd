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


# ---------------------------------------------------------------------------
# kernel 2's broadcast epilogues: rows and probe sets that reach both of its
# branches (the sorted search and the slot-by-slot compare)
# ---------------------------------------------------------------------------
ROW_KINDS = ("docids", "runs", "wrap", "high", "garbage", "empty", "single",
             "full")
PROBE_KINDS = ("sorted", "neg_middle", "unsorted", "all_neg")
_U32 = np.uint64(2**32)


def probe_row(rng, kind, B):
    """``(base, gaps)`` of one block of ``kind``, both uint64 < 2^32; its
    values are ``(base + cumsum(gaps)) mod 2^32``, as a d-gap decode gives
    them. ``docids`` ascend with runs of gap 0 (repeated docids), ``runs``
    repeat each docid many times, ``wrap`` passes 2^32 at slot n // 2,
    ``high`` crosses 2^31 (its upper values never match a probe),
    ``garbage`` is random and ``empty`` has count 0."""
    n = {"empty": 0, "single": 1, "full": B}.get(kind)
    n = int(rng.integers(2, B + 1)) if n is None else n
    gaps = rng.choice(np.array([0] * 14 + [1, 9] if kind == "runs"
                               else [0, 0, 1, 2, 37, 1000], np.uint64), n)
    cs = np.cumsum(gaps, dtype=np.uint64)
    if kind == "garbage":
        vals = rng.integers(0, 2**32, n, dtype=np.uint64)
        base = np.uint64(rng.integers(0, 2**32))
        prev = np.concatenate([[base], vals[:-1]]).astype(np.uint64)
        return base, (vals + _U32 - prev) % _U32
    if kind == "wrap":
        start = _U32 - cs[n // 2] if cs[n // 2] else _U32 - np.uint64(1)
    elif kind == "high":
        start = np.uint64(rng.integers(2**31 - 3000, 2**31 + 3000))
    else:
        start = np.uint64(rng.integers(0, 2**31 - 2**20))
    return start % _U32, gaps


def probe_rows(rng, nb, B, kind="mixed"):
    """``(bases uint64 [nb], gap lists, value lists)`` of ``nb`` blocks of
    ``kind``; ``mixed`` cycles through every row kind from a random one."""
    k0 = int(rng.integers(len(ROW_KINDS)))
    bases, gaps, vals = np.zeros(nb, np.uint64), [], []
    for t in range(nb):
        k = kind if kind != "mixed" else ROW_KINDS[(k0 + t) % len(ROW_KINDS)]
        base, g = probe_row(rng, k, B)
        bases[t] = base
        gaps.append(g)
        vals.append((base + np.cumsum(g, dtype=np.uint64)) % _U32)
    return bases, gaps, vals


def probe_set(rng, kind, grid, counts, P):
    """int32 ``[1, P]``: 3/4 of it real probes (< 2^31, half drawn from the
    rows' values, some repeated), then -1 — a ``sorted`` set as the search
    path builds it; or with -1 in its middle (``neg_middle``), shuffled
    (``unsorted``) or all negative (``all_neg``)."""
    if kind == "all_neg":
        out = np.full((1, P), -1, np.int32)
        out[0, ::3] = -(2**31)
        return out
    grid = np.asarray(grid).view(np.uint32)
    pool = grid[np.arange(grid.shape[1])[None, :] < counts[:, None]]
    pool = pool[pool < 2**31].astype(np.int64)
    n = P - P // 4
    half = (n + 1) // 2 if pool.size else 0
    lo, hi = (int(pool.min()), int(pool.max()) + 1) if pool.size else (0,
                                                                       2**31)
    picks = np.concatenate([rng.choice(pool, half) if half
                            else np.zeros(0, np.int64),
                            rng.integers(lo, hi, n - half)])
    if n >= 8:  # repeated probes
        picks[: n // 8] = picks[n - n // 8:]
    out = np.full((1, P), -1, np.int32)
    out[0, :n] = np.sort(picks).astype(np.int32)
    if kind == "neg_middle":
        out[0, n // 2] = -1
    elif kind == "unsorted":
        out[0] = rng.permutation(out[0])
    return out


def probe_weights(rng, counts):
    """Per-block weight lists of every byte length up to 32 bits, so sums
    over repeated docids wrap mod 2^32."""
    return [rng.integers(0, 2**32, int(c), dtype=np.uint64)
            >> rng.integers(0, 32, int(c)).astype(np.uint64) for c in counts]
