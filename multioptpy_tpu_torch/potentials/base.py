"""Bias-potential engine on batched coordinates.

Counterpart of `multioptpy_tpu/potentials/base.py`. Each potential is a
function `energy(coords (B, N, 3), params) -> (B,)`; the engine sums them
and differentiates the sum: the gradient by autograd (members are
independent), the Hessian by `torch.func` forward-over-reverse per member,
the counterpart of `jax.hessian`. NEB images and IRC branches call it as a
batch.

Atom indices in configs are 1-based (reference CLI convention) and
converted to 0-based arrays here.
"""

import numpy as np
import torch


def idx0(atoms):
    """1-based index list -> 0-based int32 numpy array."""
    return np.asarray(atoms, dtype=np.int32) - 1


class BiasPotential:
    """Base class. Subclasses define `name`, `init_params()` and
    `energy(coords (B, N, 3), params) -> (B,)`."""

    name = "base"

    def __init__(self, **config):
        self.config = config

    def init_params(self):
        """Continuously tunable parameters as a 1-D float array."""
        return np.zeros((0,), dtype=np.float64)

    def energy(self, coords, params):
        raise NotImplementedError


class BiasEngine:
    """Sums a static list of potentials into one differentiable function
    of a batch (B, N, 3)."""

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
    """Instantiate a potential by name; this port registers "afir" only
    (the rest are ROADMAP Queue 1 item 13)."""
    import multioptpy_tpu_torch.potentials  # noqa: F401  (registration)
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"bias potential '{name}': this port has {sorted(_REGISTRY)}; "
            "the other potentials arrive with ROADMAP Queue 1 item 13")
    return _REGISTRY[name](**config)


def available_potentials():
    import multioptpy_tpu_torch.potentials  # noqa: F401
    return sorted(_REGISTRY)
