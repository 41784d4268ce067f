"""Meshes (port of ``repro.launch.mesh``).

A :class:`Mesh` is axis names, axis sizes and a grid of torch devices.  A
device may repeat: four ``model`` shards may sit on one card, as the node
layouts' device lists do (``api.ExperimentSpec.devices``).  Functions, not
module constants, so importing this module touches no device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.lm import resolve_device


class Mesh:
    """``devices``: a grid (numpy object array) of ``torch.device`` whose
    dimensions are the axes ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.shape} device grid for axes {self.axis_names}")

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, **coords) -> torch.device:
        """The device at the given axis coordinates (the others at 0)."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, {sorted(set(map(str, self.devices.flat)))})"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, the device a tensor made
    there reports, so that a shard on it reads views."""
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" and dev.index is None else dev


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (single pod, 256 chips) or 2x16x16 (two pods, 512 chips) as a
    logical mesh on the ``meta`` device: it needs no hardware, and what is
    laid out on it allocates nothing (``launch/dryrun``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, torch.device("meta"), dtype=object), axes)


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over ``devices`` (data * model of them; a device
    may repeat, ``("cuda",) * 4`` puts four shards on one card), or over the
    first data * model visible CUDA devices."""
    n = data * model
    if devices is None:
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"a {data}x{model} mesh needs {n} CUDA devices, {torch.cuda.device_count()} visible; "
                               "pass devices (a device may repeat)")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"a {data}x{model} mesh needs {n} devices, got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [_indexed(resolve_device(d)) for d in devices]
    return Mesh(grid.reshape(data, model), ("data", "model"))
