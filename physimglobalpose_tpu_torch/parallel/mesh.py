"""Device lists in a ("data", "model") layout, and the helpers that split a
leading axis over them.

The JAX package builds a jax.sharding.Mesh and lets XLA place shards. The
port's counterpart is one process that drives a list of devices itself: an
array is padded to a multiple of the device count, split into contiguous
chunks, each chunk is moved to its device, the work runs there, and the
results come back to the first device. The JAX path has no collective
beyond the gather its out_shardings imply, so no torch.distributed process
group is needed and no launcher either.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (data, model) array of torch.devices (`devices`), with the axis
    names and shape dict of a jax.sharding.Mesh."""

    devices: np.ndarray  # [data, model] of torch.device
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """Every device, row-major: shard i of a split lives on entry i."""
        return list(self.devices.reshape(-1))


def make_mesh(
    n_devices: int | None = None, data: int | None = None, model: int | None = None,
    device=None,
) -> DeviceMesh:
    """A ("data", "model") mesh over the first n_devices devices.

    device: "cuda" (the default) lists every card (torch.cuda.device_count());
    "cpu" gives n_devices entries of torch.device("cpu") (one when not
    given: the CPU is one device), the counterpart of the virtual CPU
    devices JAX's tests run on. Default
    split, the JAX package's: the model axis gets the largest power of two
    <= sqrt(n) that divides n, data the rest.
    """
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [torch.device(kind)] * (n_devices or 1)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, {len(devs)} present")
    devs = devs[:n]
    if data is None or model is None:
        model = 1
        while model * 2 <= int(np.sqrt(n)) and n % (model * 2) == 0:
            model *= 2
        data = n // model
    assert data * model == n, (data, model, n)
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(data, model))


def padded_length(n: int, mesh: DeviceMesh | None) -> int:
    """n rounded up to a multiple of the mesh size (n without a mesh)."""
    size = 1 if mesh is None else mesh.size
    return n + (-n) % size


def pad_rows(x: torch.Tensor, length: int) -> torch.Tensor:
    """Pad the leading axis to `length` by repeating row 0 (padded rows are
    computed and discarded, as the JAX package pads its shards)."""
    pad = length - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> list:
    """One copy of x on every device of the mesh (shared where two entries
    are the same device)."""
    copies: dict = {}
    return [copies.setdefault(d, x.to(d, non_blocking=True)) for d in mesh.device_list]


def shard_along(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> list:
    """Split x along `dim` into mesh.size contiguous chunks, chunk i on
    device i. The length along dim must be a multiple of the mesh size
    (pad_rows first)."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"length {n} is no multiple of the mesh size {mesh.size}")
    return [c.to(d, non_blocking=True)
            for c, d in zip(x.split(n // mesh.size, dim=dim), mesh.device_list)]


def gather(parts: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """Concatenate per-device results on `device` (the mesh's first)."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=dim)
