"""The mesh: a named grid of devices, driven by one process.

The port of ``repro/distributed/api.py``'s mesh plumbing. The reference
runs single-controller: one program places arrays on a ``jax`` mesh and
runs a body once per shard, with no collective. The port keeps that
shape with a plain :class:`Mesh` — a numpy object array of
``torch.device``\\ s with named axes — and no ``torch.distributed``
process group. A device may appear more than once: several logical
shards on one card (or on ``cpu`` in the tests), the counterpart of the
reference's forced host-device count.

``activate_mesh`` / ``current_mesh`` keep a thread-local mesh for code
that asks which mesh it runs under; ``_resolve_axes`` drops axis names the
mesh does not have, as the reference does (``'pod'`` on one pod).
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

_state = threading.local()


class Mesh:
    """Devices on a grid with one name per axis.

    ``devices`` is a numpy object array of ``torch.device`` of shape
    ``[mesh.shape[a] for a in axis_names]``; ``shape`` maps each axis name
    to its size. Two meshes are equal when their axis names and device
    grids are.
    """

    def __init__(self, devices, axis_names):
        grid = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {grid.shape} needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.devices = grid
        self.axis_names = axis_names
        # what equality compares, worked out once: dispatch compares the
        # meshes of every sharded operand on every call
        self._key = (axis_names, grid.shape,
                     tuple(str(d) for d in grid.flat))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __eq__(self, other):
        return self is other or (isinstance(other, Mesh)
                                 and self._key == other._key)

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"Mesh({self.shape}, [{devs}])"


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A mesh of ``shape`` with ``axis_names``.

    By default the mesh lies over every card, in order: with fewer cards
    than mesh positions each card takes an equal run of consecutive
    positions (``(8,)`` on one card is 8 logical shards of ``cuda:0``, on
    four cards two a card). Raises without a card. ``devices=`` gives the
    ``prod(shape)`` devices explicitly, in row-major order; a device may
    repeat.
    """
    shape = tuple(int(s) for s in np.atleast_1d(shape))
    n = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh lays the mesh over the CUDA cards and none is "
                "available; pass devices= (e.g. ['cpu'] * n) to build one "
                "elsewhere")
        cards = torch.cuda.device_count()
        if n % cards and cards % n:
            raise ValueError(f"a mesh of {n} positions does not divide "
                             f"evenly over {cards} cards; pass devices=")
        per = max(n // cards, 1)
        devices = [torch.device("cuda", i // per) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"mesh shape {shape} needs {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activate_mesh(mesh: Mesh):
    """Thread-local mesh context (nothing global is touched)."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _resolve_axes(axes, mesh: Mesh):
    """Drop axis names not present in the mesh (e.g. 'pod' on 1 pod)."""
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in mesh.axis_names)
            out.append(kept if kept else None)
        else:
            out.append(a if a in mesh.axis_names else None)
    return tuple(out)
