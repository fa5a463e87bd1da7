"""Peer grids for the trainer: the port's counterpart of
``src/repro/launch/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over devices; the port runs
every peer on one card, so its mesh is the grid alone: the axis names and
their sizes. ``make_host_mesh(dp, tp)`` gives the reference's ``('data',
'model')`` grid (a ``model`` axis of size > 1 is tensor parallelism, or the
second data level under ``TrainConfig.pure_dp``); ``make_production_mesh``
the reference's production grids: 16 x 16 ``(data, model)``, or 2 x 16 x 16
``(pod, data, model)`` with ``multi_pod``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HostMesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"axis sizes must be positive, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_host_mesh(dp: int = 1, tp: int = 1) -> HostMesh:
    """The ``(data, model)`` grid of ``dp`` x ``tp`` peers."""
    return HostMesh(("data", "model"), (int(dp), int(tp)))


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The reference's production grid: one pod of 16 x 16 ``(data,
    model)`` ranks, or two such pods with a leading ``pod`` axis."""
    if multi_pod:
        return HostMesh(("pod", "data", "model"), (2, 16, 16))
    return HostMesh(("data", "model"), (16, 16))
