"""Mesh definitions for the launchers.

The port of ``repro/launch/mesh.py``'s single-host part: ``dp_degree`` and
the 1-device host mesh. The production meshes of 256 and 512 TPU chips
wait for the multi-card slice (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.distributed.api import Mesh, make_mesh


def dp_degree(mesh: Mesh) -> int:
    """The data-parallel width: the product of the ``pod`` and ``data``
    axes the mesh has."""
    n = 1
    for name in ("pod", "data"):
        if name in mesh.axis_names:
            n *= mesh.shape[name]
    return n


def make_host_mesh(device=None) -> Mesh:
    """A 1-device mesh with the single-pod axis names ``("data",
    "model")`` on ``device`` (default: the card)."""
    return make_mesh((1, 1), ("data", "model"),
                     devices=[resolve_device(device)])
