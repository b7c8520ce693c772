"""Device-mesh parallelism for the scheduling cycle (a port of
cook_tpu/parallel/).

Two axes of scale, as in the reference:

  pools.py          per-pool scheduling loops, pools sharded over the
                    mesh's devices; cluster-wide totals by `psum`.
  sharded_match.py  one pool's (jobs x hosts) match problem sharded over
                    the mesh's host axis: a distributed sequential greedy
                    with a per-step `pmax` / `pmin` argmax reduction.
  federation.py     pool-sharded cycles over a 2-D (slice x pools) mesh,
                    totals reduced over pools, then over slices.

The reference is single-controller: one process holds the whole mesh
(`jax.sharding.Mesh` under `shard_map`). So is the port: a `Mesh` is a
grid of `torch.device`s in one process, a sharded value is a list of
per-shard tensors in the order of `mesh.devices.flat`, and the
collectives below are plain functions over such lists. A device repeats
in a mesh only when the caller lists it explicitly: a CPU test mesh of
eight shards is `Mesh([torch.device("cpu")] * 8, ...)`, the counterpart
of the JAX tests' eight virtual CPU devices.
"""
from __future__ import annotations

import numpy as np
import torch

from cook_tpu_torch.device import resolve_device


class Mesh:
    """Devices in an n-D grid with one name per axis.

    `devices` is a numpy object array of `torch.device`s (so
    `mesh.devices.size` and `mesh.devices.flat` read as in JAX),
    `axis_names` a tuple of str, and `shape[axis]` the size of an axis.
    Hashable: cached matchers are keyed on it."""

    def __init__(self, devices, axis_names):
        axis_names = tuple(axis_names)
        shape = (np.shape(devices) if isinstance(devices, np.ndarray)
                 else (len(devices),))
        if len(shape) != len(axis_names):
            raise ValueError(f"a mesh of shape {shape} needs {len(shape)} "
                             f"axis names, got {axis_names}")
        flat = [resolve_device(d) if not isinstance(d, torch.device) else d
                for d in (np.ravel(devices) if isinstance(devices, np.ndarray)
                          else devices)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        grid = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            grid[i] = d
        self.devices = grid.reshape(shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat),
                self.devices.shape, self.axis_names)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape})")


def visible_devices(n=None, device="cuda") -> list:
    """The first `n` devices of type `device` (all of them when n is
    None): CUDA devices 0..n-1, or the one CPU. Raises when fewer than
    `n` are visible; never repeats a device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")]
    n = len(devs) if n is None else n
    if n > len(devs):
        raise ValueError(f"need {n} {dev.type} devices, have {len(devs)}; "
                         f"list repeated devices explicitly (devices=) to "
                         f"run more shards than devices")
    return devs[:n]


def _groups(mesh: Mesh, axis) -> list:
    """Flat shard indices that reduce together over `axis` (an axis
    name, a tuple of names, or None for every axis), one list a group,
    each in mesh order."""
    ids = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    if axis is None:
        return [ids.ravel().tolist()]
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    ax = [mesh.axis_names.index(a) for a in names]
    moved = np.moveaxis(ids, ax, list(range(ids.ndim - len(ax), ids.ndim)))
    size = int(np.prod([ids.shape[a] for a in ax]))
    return moved.reshape(-1, size).tolist()


def _allreduce(parts, mesh: Mesh, axis, op) -> list:
    """op over each group's shards, on the group's first device, handed
    back to every shard of the group on its own device. Copies between
    devices are stream-ordered; nothing is read to the host. Shards on
    one device may share the result's storage."""
    if len(parts) != mesh.devices.size:
        raise ValueError(f"{len(parts)} parts for a mesh of "
                         f"{mesh.devices.size} shards")
    devs = list(mesh.devices.flat)
    out = [None] * len(parts)
    for group in _groups(mesh, axis):
        root = devs[group[0]]
        red = op([parts[i].to(root, non_blocking=True) for i in group])
        for i in group:
            out[i] = red.to(devs[i], non_blocking=True)
    return out


def pmax(parts, mesh: Mesh, axis=None) -> list:
    """Elementwise maximum over the shards of `axis` (`lax.pmax`)."""
    return _allreduce(parts, mesh, axis,
                      lambda xs: torch.stack(xs).amax(dim=0))


def pmin(parts, mesh: Mesh, axis=None) -> list:
    """Elementwise minimum over the shards of `axis` (`lax.pmin`)."""
    return _allreduce(parts, mesh, axis,
                      lambda xs: torch.stack(xs).amin(dim=0))


def psum(parts, mesh: Mesh, axis=None) -> list:
    """Elementwise sum over the shards of `axis` (`lax.psum`), added in
    mesh order, in the parts' dtype."""
    def add(xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc

    return _allreduce(parts, mesh, axis, add)
