"""Device meshes for ensembles and bands, in one process.

Counterpart of `multioptpy_tpu/parallel/mesh.py`. The reference places a
batched pytree on a 1-D `jax.sharding.Mesh` and lets XLA partition the
program. Here a `Mesh` is an ordered list of torch devices with one axis
name (a device may repeat: `["cpu"] * 8` in the tests, `[cuda:0] * 4` on
one card), and a sharded tree is a `ShardedTree`: one tree per shard, each
on its shard's device. Every shard runs its own calls on its own device;
halo copies, gathers and reductions are explicit copies and sums in shard
order, inside one process. The same code runs a mesh of distinct GPUs.

Nothing here overlaps shards: on one card a k-shard mesh makes k times the
launches of the unsharded run.
"""

import copy
from typing import Any, NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import resolve_device


class Mesh:
    """An ordered 1-D mesh of torch devices along axis `axis_names[0]`.
    `devices` is an object array (`.size` is the shard count) and
    `shape[axis]` the shard count, as on a `jax.sharding.Mesh`."""

    def __init__(self, devices, axis="batch"):
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = (axis,)
        self.shape = {axis: len(devs)}

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def check_mesh(mesh, axis=None):
    """`mesh` itself, or TypeError if it is not a `Mesh`; ValueError if
    `axis` is given and is not its axis."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a multioptpy_tpu_torch Mesh "
                        f"(ensemble_mesh(...)), not {type(mesh).__name__}")
    if axis is not None and axis not in mesh.shape:
        raise ValueError(f"mesh axis {axis!r} is not one of "
                         f"{mesh.axis_names}")
    return mesh


def mesh_device(mesh, device=None):
    """The device a mesh run gathers its results on: the mesh's first.
    `device`, if given, must be that device."""
    home = check_mesh(mesh).devices[0]
    if device is not None and resolve_device(device) != home:
        raise ValueError(f"device {resolve_device(device)} and the mesh's "
                         f"first device {home} disagree")
    return home


def ensemble_mesh(n_devices=None, axis="batch", devices=None):
    """A 1-D mesh over every visible CUDA device (or the first
    `n_devices`), or over `devices` as given. A device repeats only when
    `devices` repeats it (`[torch.device("cuda", 0)] * 4`, `["cpu"] * 8`);
    no mesh is ever made of the CPU unless `devices` names it."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("ensemble_mesh: no CUDA device is visible; "
                               "pass devices=[...] (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"ensemble_mesh: n_devices={n_devices}, but "
                             f"{len(devices)} devices are available")
        devices = devices[:n_devices]
    return Mesh(devices, axis)


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------

def _is_record(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, *trees):
    """fn over the leaves of matching trees (NamedTuples, tuples, lists),
    following the first tree's structure (its leaves may be None)."""
    first = trees[0]
    if _is_record(first):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


class ShardedTree(NamedTuple):
    """A tree split over a mesh: `shards[i]` is shard i's tree, its tensors
    on `mesh.devices[i]`; `axes` is a tree of the same structure holding,
    for each leaf, the dimension it is split along (None: the leaf is
    copied whole to every shard)."""

    shards: tuple
    axes: Any
    mesh: Mesh

    def gather(self):
        """The whole tree on the mesh's first device: split leaves
        concatenated in shard order, copied leaves taken from shard 0."""
        home = self.mesh.devices[0]

        def join(ax, *parts):
            if not isinstance(parts[0], torch.Tensor):
                return parts[0]
            if ax is None:
                return parts[0].to(home)
            return torch.cat([p.to(home) for p in parts], dim=ax)

        return tree_map(join, self.axes, *self.shards)

    @property
    def split(self):
        """True when at least one leaf is split."""
        return any(ax is not None for ax in _leaves(self.axes))


def shard_tree(tree, mesh, axes):
    """Split `tree` over `mesh` along the per-leaf dimensions of the tree
    `axes` (None: copy the leaf whole to every shard); each shard's leaves
    on its device. A split dimension must divide by the shard count."""
    k = check_mesh(mesh).size

    def check(ax, x):
        if ax is not None and x.shape[ax] % k:
            raise ValueError(f"dimension {ax} of a {tuple(x.shape)} leaf "
                             f"does not divide over {k} shards")

    tree_map(check, axes, tree)
    shards = []
    for i, dev in enumerate(mesh.devices):
        def piece(ax, x, i=i, dev=dev):
            if not isinstance(x, torch.Tensor):
                return x
            if ax is None:
                return x.to(dev)
            n = x.shape[ax] // k
            return x.narrow(ax, i * n, n).to(dev)
        shards.append(tree_map(piece, axes, tree))
    return ShardedTree(tuple(shards), axes, mesh)


def shard_batch(tree, mesh, axis="batch"):
    """Split every tensor leaf of a batched tree along its leading axis in
    contiguous blocks, one per shard in shard order, each on its shard's
    device. A leaf whose leading dimension does not divide (or a 0-d leaf)
    is copied whole to every shard, as the reference's replicated `P()`."""
    k = check_mesh(mesh, axis).size

    def spec(x):
        if (isinstance(x, torch.Tensor) and x.ndim >= 1
                and x.shape[0] % k == 0):
            return 0
        return None

    def to_tensor(x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x)
        return x

    tree = tree_map(to_tensor, tree)
    return shard_tree(tree, mesh, tree_map(spec, tree))


def map_shards(fn, tree):
    """fn(i, device, shard_tree) for every shard in shard order. The result
    is a ShardedTree whose leaves are split along dimension 0, or copied
    whole when no leaf of `tree` is split (each shard then computed the
    whole batch, as a replicated layout does)."""
    outs = tuple(fn(i, dev, sh) for i, (dev, sh)
                 in enumerate(zip(tree.mesh.devices, tree.shards)))
    ax = 0 if tree.split else None
    return ShardedTree(outs, tree_map(lambda _: ax, outs[0]), tree.mesh)


def ordered_sum(parts, device):
    """The sum of per-shard partial sums, added in shard order on
    `device`."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def shard_calc(calc, device):
    """`calc` when it lives on `device`, else a shallow copy that does: a
    calculator builds its tables on the device of the coordinates it is
    given, so each shard evaluates on its own device."""
    if calc.device == device:
        return calc
    other = copy.copy(calc)
    other.device = device
    return other


def sharded_optimize_batch(calc, coords_batch, z, mesh=None, bias_engine=None,
                           config=None, n_steps=50, axis="batch"):
    """Batched ensemble optimization with the batch split over a mesh:
    every shard advances its block of B/k structures in lockstep, converged
    members frozen (drivers/optimize.make_step_fn); the OptResult is
    gathered in shard order on the mesh's first device. `mesh` None takes
    every visible CUDA device."""
    from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                       optimize_batch)

    config = config or OptimizeConfig()
    mesh = ensemble_mesh(axis=axis) if mesh is None else mesh
    check_mesh(mesh, axis)
    return optimize_batch(calc, coords_batch, z, bias_engine=bias_engine,
                          config=config, n_steps=n_steps, mesh=mesh)


def tp_energy_and_gradient(calc, coords, z, mesh=None, axis="tp"):
    """The tensor-parallel SQM energy and gradient of ONE molecule (N, 3):
    the calculator builds its O(N^2) pair geometry and overlap blocks in
    row blocks, one per shard of `axis` (calculators/sqm.py
    `_tp_shard_rows`), and runs everything after them (the EEQ solve, the
    band eigensolve, repulsion, dispersion) once, on the mesh's first
    device. Returns a 0-d energy and an (N, 3) gradient there. `mesh` None
    takes every visible CUDA device. `calc` is sharded for this call only:
    its previous `tp_mesh` and `tp_axis` come back afterwards."""
    mesh = ensemble_mesh(axis=axis) if mesh is None else mesh
    home = mesh_device(check_mesh(mesh, axis))
    if calc.device != home:
        raise ValueError(f"the calculator lives on {calc.device}, but the "
                         f"mesh gathers on {home}")
    x = coords if isinstance(coords, torch.Tensor) else torch.as_tensor(
        np.asarray(coords), device=home)
    prev = (getattr(calc, "tp_mesh", None), getattr(calc, "tp_axis", "tp"))
    calc.tp_mesh, calc.tp_axis = mesh, axis
    try:
        e, g = calc.energy_and_gradient(x[None], z)
    finally:
        calc.tp_mesh, calc.tp_axis = prev
    return e[0], g[0]
