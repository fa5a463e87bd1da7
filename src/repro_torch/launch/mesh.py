"""Peer grids for the trainer: the port's counterpart of
``src/repro/launch/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over devices; the port runs
every peer on one card, so its mesh is the grid alone: the axis names and
their sizes. ``make_host_mesh(dp, tp)`` gives the reference's ``('data',
'model')`` grid; the trainer runs a ``model`` axis of size > 1 only as the
second data level of ``TrainConfig.pure_dp`` (tensor parallelism is ROADMAP
A15b).
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
    raise NotImplementedError("the production mesh (16 x 16 data x model, "
                              "tensor parallel) is not ported yet: ROADMAP "
                              "A15b")
