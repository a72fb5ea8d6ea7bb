"""Calculator protocol: batched energy backends on tensors.

Counterpart of `multioptpy_tpu/calculators/base.py`. A calculator is a
function of a batch of geometries:

    energy(coords_bohr (B, N, 3), z (N,) ints) -> Hartree (B,)

Gradients come from autograd of the summed batch energy (members are
independent, so each member's gradient is its own), and the seminumerical
Hessian evaluates all 6N displaced gradients of all B structures as one
batch.
"""

import torch

from multioptpy_tpu_torch.device import resolve_device


class Calculator:
    """Base class. Subclasses implement `energy(coords, z)`.

    `device` (None means the CUDA card) is where the calculator's parameter
    tensors live; callers pass coordinates on the same device."""

    on_device = True
    name = "base"

    def __init__(self, charge=0, multiplicity=1, device=None, **kwargs):
        self.charge = int(charge)
        self.multiplicity = int(multiplicity)
        self.device = resolve_device(device)
        self.options = kwargs

    def energy(self, coords, z):
        raise NotImplementedError

    def energy_and_gradient(self, coords, z):
        """-> (E (B,), g (B, N, 3)), both detached."""
        with torch.enable_grad():
            x = coords.detach().requires_grad_(True)
            e = self.energy(x, z)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), g

    def gradient(self, coords, z):
        return self.energy_and_gradient(coords, z)[1]

    def hessian(self, coords, z):
        """Exact Hessians (B, 3N, 3N): forward-over-reverse autodiff of each
        member's energy (SQM/SQM2 override this with their seminumerical
        Hessian)."""
        b, n, _ = coords.shape

        def one(x_flat):
            return self.energy(x_flat.reshape(1, n, 3), z)[0]

        return torch.func.vmap(torch.func.hessian(one))(
            coords.detach().reshape(b, 3 * n))

    def numerical_hessian(self, coords, z, step=1e-3):
        """Central-difference Hessians (B, 3N, 3N) of the analytic gradient:
        all 6N displaced gradients of all B structures in one batch."""
        b, n, _ = coords.shape
        n3 = 3 * n
        eye = torch.eye(n3, dtype=coords.dtype, device=coords.device) * step
        flat = coords.reshape(b, 1, n3)
        disp = torch.cat([flat + eye, flat - eye], dim=1)   # (B, 6N, 3N)
        g = self.energy_and_gradient(disp.reshape(b * 2 * n3, n, 3), z)[1]
        g = g.reshape(b, 2, n3, n3)
        h = (g[:, 0] - g[:, 1]) / (2.0 * step)
        return 0.5 * (h + h.mT)


_REGISTRY = {}


def register_calculator(name):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_calculator(name, **kwargs):
    """Instantiate a backend by name: "sqm", "sqm2" or "muller_brown" in
    this port."""
    from multioptpy_tpu_torch.calculators import (  # noqa: F401
        model_surfaces, sqm)
    if name not in _REGISTRY:
        raise KeyError(f"unknown calculator '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_calculators():
    from multioptpy_tpu_torch.calculators import (  # noqa: F401
        model_surfaces, sqm)
    return sorted(_REGISTRY)
