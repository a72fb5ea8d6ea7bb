"""Bias-potential engine on batched coordinates.

Counterpart of `multioptpy_tpu/potentials/base.py`. Each potential is a
function `energy(coords (B, N, 3), params) -> (B,)`; the engine sums them
and differentiates the sum: the gradient by autograd (members are
independent), the Hessian by `torch.func` forward-over-reverse per member,
the counterpart of `jax.hessian`. NEB images and IRC branches call it as a
batch. AFIR is written on the batch; the other potentials write the
reference's one-structure energy `energy_one(coords (N, 3), params)`,
which the base class maps over the batch with `torch.func.vmap`.

Atom indices in configs are 1-based (reference CLI convention) and
converted to 0-based arrays here.
"""

from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.units import ANGSTROM2BOHR

_CONSTANTS = {}


def idx0(atoms):
    """1-based index list -> 0-based int32 numpy array."""
    return np.asarray(atoms, dtype=np.int32) - 1


def const(array, like, dtype=None):
    """`array` (numpy) as a tensor on `like`'s device (in `like`'s dtype, or
    `dtype`), kept per device so that an energy call copies no table to the
    card; integer arrays become int64 index tensors."""
    a = np.asarray(array)
    if dtype is None:
        if a.dtype == bool:
            dtype = torch.bool
        elif a.dtype.kind in "iu":
            dtype = torch.long
        else:
            dtype = like.dtype
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, str(like.device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype,
                                              device=like.device)
    return t


def _dist(a, b, eps=1e-12):
    d = a - b
    return torch.sqrt((d * d).sum(-1) + eps)


def _angle(p1, p2, p3, eps=1e-12):
    """Angle p1-p2-p3 in radians via atan2, over points (..., 3)."""
    v1 = p1 - p2
    v2 = p3 - p2
    cross = torch.linalg.cross(v1, v2, dim=-1)
    return torch.atan2(torch.sqrt((cross * cross).sum(-1) + eps),
                       (v1 * v2).sum(-1))


def _fragment_center(coords, indices):
    """Mean of the (N, 3) rows `indices`."""
    return coords[const(indices, coords)].mean(0)


def _dihedral(p1, p2, p3, p4, eps=1e-12):
    """Signed dihedral in radians, phi = atan2((n1 x n2) . b2_hat, n1 . n2)
    (IUPAC sign convention), over points (..., 3)."""
    b1 = p2 - p1
    b2 = p3 - p2
    b3 = p4 - p3
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    b2n = b2 / torch.sqrt((b2 * b2).sum(-1, keepdim=True) + eps)
    x = (n1 * n2).sum(-1)
    y = (torch.linalg.cross(n1, n2, dim=-1) * b2n).sum(-1)
    return torch.atan2(y, x)


def ang_to_bohr(x):
    """Angstrom -> Bohr, as a float64 numpy array."""
    return np.asarray(x, dtype=np.float64) * ANGSTROM2BOHR


class BiasPotential:
    """Base class. Subclasses define `name`, `init_params()` and either
    `energy(coords (B, N, 3), params) -> (B,)` or the one-structure
    `energy_one(coords (N, 3), params) -> ()`."""

    name = "base"

    def __init__(self, **config):
        self.config = config

    def init_params(self):
        """Continuously tunable parameters as a 1-D float array."""
        return np.zeros((0,), dtype=np.float64)

    def energy(self, coords, params):
        return torch.func.vmap(self.energy_one, in_dims=(0, None))(coords,
                                                                   params)

    def energy_one(self, coords, params):
        raise NotImplementedError


class BiasResult(NamedTuple):
    energy: torch.Tensor         # (B,) bias energy (Hartree)
    gradient: torch.Tensor       # (B, N, 3) bias gradient (Hartree/Bohr)
    param_grads: tuple           # dE/dparams per potential


class BiasEngine:
    """Sums a static list of potentials into one differentiable function
    of a batch (B, N, 3).

        e, g = engine.energy_and_gradient(coords)
        hess = engine.hessian(coords)                   # (B, 3N, 3N)
        res = engine.compute(coords)                    # + dE/dparams
    """

    def __init__(self, potentials):
        self.potentials = list(potentials)
        self._params_np = tuple(np.asarray(p.init_params(), np.float64)
                                for p in self.potentials)
        self._params = {}

    def params(self, dtype, device):
        """The potentials' parameters as tensors of `dtype` on `device`."""
        key = (dtype, device)
        if key not in self._params:
            self._params[key] = tuple(
                torch.as_tensor(p, dtype=dtype, device=device)
                for p in self._params_np)
        return self._params[key]

    def total_energy(self, coords, params=None):
        """(B, N, 3) -> (B,) summed bias energy."""
        if params is None:
            params = self.params(coords.dtype, coords.device)
        e = torch.zeros(coords.shape[0], dtype=coords.dtype,
                        device=coords.device)
        for pot, prm in zip(self.potentials, params):
            e = e + pot.energy(coords, prm)
        return e

    def energy_and_gradient(self, coords):
        """-> (e (B,), g (B, N, 3)), both detached."""
        with torch.enable_grad():
            x = coords.detach().requires_grad_(True)
            e = self.total_energy(x)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), g

    def compute(self, coords):
        """Energy, gradient and each potential's dE/dparams (the
        parameters of `init_params()`), by autograd; the parameter
        gradients are those of the batch's summed energy (of the one
        structure for a batch of one)."""
        with torch.enable_grad():
            x = coords.detach().requires_grad_(True)
            prms = tuple(p.detach().requires_grad_(True)
                         for p in self.params(x.dtype, x.device))
            e = self.total_energy(x, prms)
            grads = torch.autograd.grad(e.sum(), (x,) + prms,
                                        allow_unused=True)
        pgrads = tuple(torch.zeros_like(p) if g is None else g
                       for p, g in zip(prms, grads[1:]))
        return BiasResult(e.detach(), grads[0], pgrads)

    def hessian(self, coords):
        """(B, N, 3) -> (B, 3N, 3N)."""
        b, n, _ = coords.shape
        params = self.params(coords.dtype, coords.device)

        def one(x_flat):
            return self.total_energy(x_flat.reshape(1, n, 3), params)[0]

        return torch.func.vmap(torch.func.hessian(one))(
            coords.detach().reshape(b, 3 * n))

    def __len__(self):
        return len(self.potentials)


_REGISTRY = {}


def register_potential(cls):
    _REGISTRY[cls.name] = cls
    return cls


def get_potential(name, **config):
    """Instantiate a potential by name."""
    import multioptpy_tpu_torch.potentials  # noqa: F401  (registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown bias potential '{name}'; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**config)


def available_potentials():
    import multioptpy_tpu_torch.potentials  # noqa: F401
    return sorted(_REGISTRY)
