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

A sharding is a :class:`NamedSharding`: the mesh and a spec, a tuple with
one entry a dimension (an axis name, a tuple of names, or ``None``), which
compares equal to the reference's ``PartitionSpec`` entries.
``constrain(x, *axes)`` lays ``x`` out by such a spec under the active
mesh (``sharding.place``: a leaf split along up to two dimensions, over
the data axes and ``model``, or one copy on each distinct device) and is
a no-op without one. The train step's hooks make the two moves the
reference's ZeRO-1 asks of it: a gather of the master slices into a bf16
compute copy (split over ``model`` as the rule says, whole over the data
axes), and the layout of a replica's gradients in the master's slices.
The layouts the reference's ``constrain`` fixes at a function's boundary
over ``model`` are the port's too: prefill's cache split along the
sequence ``(None, DP, TP, None, None)``, logits over the vocabulary
``(DP, TP)``, MoE's buffers over the experts or their hidden units
(``registry.run_cell``, ``nn/moe.py::moe_apply_mp``). Inside a layer the
model code makes the ``model`` split explicit
(``distributed/tensor_parallel.py``). The reference's other calls (some
20 in ``nn/moe.py``, ``models/{lm,gnn,recsys}.py``) place activations
over the data axes; in the port each data position already holds its
own rows, so those are not carried over.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

_state = threading.local()


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card), as a
    tensor on it reports its device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices on a grid with one name per axis.

    ``devices`` is a numpy object array of ``torch.device`` of shape
    ``[mesh.shape[a] for a in axis_names]`` (a card always with its
    index); ``shape`` maps each axis name
    to its size. Two meshes are equal when their axis names and device
    grids are.
    """

    def __init__(self, devices, axis_names):
        grid = np.vectorize(_indexed, otypes=[object])(
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


@dataclass(frozen=True)
class NamedSharding:
    """A layout on ``mesh``: ``spec`` has one entry a dimension, an axis
    name, a tuple of names or ``None`` (axes the mesh lacks dropped)."""

    mesh: Mesh
    spec: tuple


def resolved_spec(axes, mesh: Mesh) -> tuple:
    """``axes`` against ``mesh`` (:func:`_resolve_axes`), a tuple of one
    name written as the name, as the reference's ``PartitionSpec`` keeps
    it."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in _resolve_axes(axes, mesh))


def named_sharding(mesh: Mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, resolved_spec(axes, mesh))


def constrain(x, *axes):
    """``x`` laid out by ``axes`` on the active mesh (``sharding.place``);
    ``x`` itself without one."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from .sharding import place

    return place(x, named_sharding(mesh, *axes))
