"""Meshes: named logical axes over one device, local devices or ranks.

A ``Mesh`` is axis names and sizes plus what backs them:

* **abstract** (no devices): the production shapes, for resolving
  sharding rules; it touches no device state, so ``make_production_mesh``
  is safe to call anywhere.
* **one device**: one ``torch.device``, and every axis is a tensor
  dimension on it. ``core.distributed`` runs its ``cc`` shards this way,
  as a leading dimension exchanged by transposes.
* **local devices**: one local device per position (``cell_mesh``, on
  whose cards the sweep places its cell blocks).
* **process**: a ``torch.distributed.device_mesh.DeviceMesh`` over an
  initialised process group, one rank per position (gloo on the CPU,
  NCCL across cards).

Production target, as in the JAX package: 16 x 16 ("data", "model") a
pod; the multi-pod mesh adds a leading "pod" axis.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] = ()
    device_mesh: object = None  # a DeviceMesh in the process form

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def form(self) -> str:
        if self.device_mesh is not None:
            return "process"
        if not self.devices:
            return "abstract"
        return "one_device" if len(self.devices) == 1 else "local"

    @property
    def device(self) -> torch.device:
        """This process's device: the one device, or this rank's."""
        if len(self.devices) != 1:
            raise ValueError(f"a {self.form} mesh has no single device")
        return self.devices[0]


def one_device_mesh(shape, axes, device="cuda") -> Mesh:
    """Every axis a tensor dimension on ``device``."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape),
                (torch.device(device),))


def process_mesh(shape, axes) -> Mesh:
    """A ``DeviceMesh`` over the initialised default process group, one
    rank per position (rank order = row-major positions). Its device is
    this rank's: the current CUDA card under NCCL, the CPU under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"{world} ranks for a mesh of {shape}: one rank a "
                         f"position")
    if dist.get_backend() == "nccl":
        kind, dev = "cuda", torch.device("cuda", torch.cuda.current_device())
    else:
        kind, dev = "cpu", torch.device("cpu")
    dm = DeviceMesh(kind, torch.arange(world).reshape(shape),
                    mesh_dim_names=tuple(axes))
    return Mesh(tuple(axes), shape, (dev,), dm)


def _axes(pod: int):
    return ("pod", "data", "model") if pod > 1 else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production shapes, abstract: (16, 16) ("data", "model"), or
    (2, 16, 16) with "pod"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return Mesh(_axes(2 if multi_pod else 1), shape)


def make_mesh_for(devices_or_count=None, *, data: int, model: int,
                  pod: int = 1) -> Mesh:
    """An explicit (pod,) data x model mesh.

    ``devices_or_count``: a ``torch.device`` (or its name) gives the
    one-device form there; an int or None gives the process form over
    the initialised process group (which must have ``pod * data *
    model`` ranks), or, without one, the one-device form on the default
    device ("cuda")."""
    shape = (pod, data, model) if pod > 1 else (data, model)
    axes = _axes(pod)
    if isinstance(devices_or_count, (str, torch.device)):
        return one_device_mesh(shape, axes, devices_or_count)
    n = math.prod(shape)
    if devices_or_count is not None and devices_or_count < n:
        raise ValueError(f"{devices_or_count} positions for {n}")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return process_mesh(shape, axes)
    return one_device_mesh(shape, axes)


def host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small one-device mesh on the CPU (tests)."""
    return make_mesh_for("cpu", data=data, model=model)


def local_devices() -> list[torch.device]:
    """The CUDA cards of this process, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]
