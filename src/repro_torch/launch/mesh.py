"""Mesh definitions for the launchers.

The port of ``repro/launch/mesh.py``: ``dp_degree``, the 1-device host
mesh, and the production mesh. The reference's production meshes are
its TPU pods; on a GPU host the production mesh lies over the cards
there are, all on the data axis: ``("data", "model")`` = ``(cards, 1)``,
with a leading ``pod`` axis of size 1 for ``multi_pod`` (the axis names
the rule tables use, so one code path serves both). A mesh with a
``model`` axis larger than 1 (``distributed.make_mesh((n, k), ("data",
"model"))``) is taken by ``train.jit_train_step`` and
``models.registry.run_cell`` for the LM family; the launchers keep every
card on ``data``, as the reference's do.
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.distributed.api import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """Every card on the data axis: ``("data", "model")`` of shape
    ``(cards, 1)``, or ``("pod", "data", "model")`` of ``(1, cards, 1)``
    with ``multi_pod``. ``devices=`` gives the devices instead of the
    cards (e.g. ``["cpu"]``). Raises without a card."""
    if devices is None:
        import torch

        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if multi_pod:
        return make_mesh((1, n, 1), ("pod", "data", "model"), devices=devices)
    return make_mesh((n, 1), ("data", "model"), devices=devices)


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
