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


class BondGradProjWrapper(Calculator):
    """Zero the bond-stretch gradient between atom pairs (-gfix): each
    listed pair's stretch direction, rebuilt from the current geometry, is
    projected out of the gradient, so that bond feels no force while the
    rest relaxes. Energies and Hessians are the inner calculator's."""

    def __init__(self, inner, pairs):
        self.inner = inner
        self.on_device = inner.on_device
        self.name = f"gfix({inner.name})"
        self.charge = inner.charge
        self.multiplicity = inner.multiplicity
        self.device = inner.device
        self.options = inner.options
        self.pairs = tuple((int(i) - 1, int(j) - 1) for i, j in pairs)

    def energy(self, coords, z):
        return self.inner.energy(coords, z)

    def _b_rows(self, coords):
        """(B, P, 3N) unit stretch directions."""
        rows = []
        for i, j in self.pairs:
            d = coords[:, i] - coords[:, j]
            u = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True)
                     + 1e-30)
            row = torch.zeros_like(coords)
            row[:, i] = u
            row[:, j] = -u
            rows.append(row.reshape(coords.shape[0], -1))
        return torch.stack(rows, dim=1)

    def energy_and_gradient(self, coords, z):
        e, g = self.inner.energy_and_gradient(coords, z)
        b = self._b_rows(coords)
        eye = torch.eye(b.shape[1], dtype=b.dtype, device=b.device)
        g_flat = g.reshape(g.shape[0], -1)
        coef = torch.linalg.solve_ex(b @ b.mT + 1e-12 * eye,
                                     (b @ g_flat[..., None])[..., 0])[0]
        return e, (g_flat - (b.mT @ coef[..., None])[..., 0]).reshape(
            g.shape)

    def hessian(self, coords, z):
        return self.inner.hessian(coords, z)


_REGISTRY = {}


def register_calculator(name):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_calculator(name, **kwargs):
    """Instantiate a backend by name: "sqm", "sqm2", "muller_brown" or
    "lj" in this port."""
    from multioptpy_tpu_torch.calculators import (  # noqa: F401
        lj, model_surfaces, sqm)
    if name not in _REGISTRY:
        raise KeyError(f"unknown calculator '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_calculators():
    from multioptpy_tpu_torch.calculators import (  # noqa: F401
        lj, model_surfaces, sqm)
    return sorted(_REGISTRY)
