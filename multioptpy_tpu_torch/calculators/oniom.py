"""Two-layer ONIOM (QM/QM') composite calculator on batched coordinates.

Counterpart of `multioptpy_tpu/calculators/oniom.py`. E_ONIOM =
E_low(real) + E_high(model) - E_low(model); bonds cut by the layer
boundary are capped with hydrogen link atoms along the bond at a fixed
scale factor. The caps are differentiable functions of the real
coordinates, so the ONIOM gradient, with the link atoms' chain rule,
comes from autograd, as `jax.grad` gives it. The model system keeps the
batch axis: B structures' high layers are one high-level call.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   composite_hessian)


class ONIOM(Calculator):
    """high_calc on `high_atoms` (1-based) plus H link caps; low_calc on
    all atoms.

    link_bonds: (inner_atom, outer_atom) 1-based pairs cut by the layer
    boundary; a hydrogen sits at r_inner + g (r_outer - r_inner),
    g = link_scale (default 0.709, the C-C -> C-H ratio). Lives on the
    high-level calculator's device."""

    def __init__(self, high_calc, low_calc, high_atoms, link_bonds=(),
                 link_scale=0.709, **kw):
        kw.setdefault("device", high_calc.device)
        super().__init__(**kw)
        self.high_calc = high_calc
        self.low_calc = low_calc
        self.high_idx = np.asarray([a - 1 for a in high_atoms], np.int64)
        self.link_bonds = np.asarray(
            [[i - 1, j - 1] for i, j in link_bonds], np.int64).reshape(-1, 2)
        self.link_scale = float(link_scale)
        self.on_device = high_calc.on_device and low_calc.on_device

    def _model_system(self, coords, z):
        """High-layer atoms plus H link caps -> (coords_model (B, M, 3),
        z_model (M,))."""
        parts = [coords[:, self.high_idx]]
        z_model = [np.asarray(z)[self.high_idx]]
        if len(self.link_bonds):
            inner = coords[:, self.link_bonds[:, 0]]
            outer = coords[:, self.link_bonds[:, 1]]
            parts.append(inner + self.link_scale * (outer - inner))
            z_model.append(np.ones(len(self.link_bonds), dtype=np.int64))
        return torch.cat(parts, dim=1), np.concatenate(z_model)

    def hessian(self, coords, z):
        return composite_hessian(self, coords, z)

    def energy(self, coords, z):
        coords_model, z_model = self._model_system(coords, z)
        e_low_real = self.low_calc.energy(coords, z)
        e_high_model = self.high_calc.energy(coords_model, z_model)
        e_low_model = self.low_calc.energy(coords_model, z_model)
        return e_low_real + e_high_model - e_low_model


class MicroiterONIOM(ONIOM):
    """ONIOM with low-layer microiterations (-mi): before each energy and
    gradient, the environment (the atoms outside the high layer) FIRE-
    relaxes for `microiter` steps on the low-level surface of the real
    system with the high layer frozen, so the optimizer walks an
    effective surface whose environment follows adiabatically. By the
    envelope theorem the gradient at the relaxed environment needs only
    the direct dependence on the high layer: the relaxation is not
    differentiated. microiter = 0 is plain ONIOM."""

    def __init__(self, *args, microiter=0, micro_dt=0.3, **kw):
        super().__init__(*args, **kw)
        self.microiter = int(microiter)
        self.micro_dt = float(micro_dt)

    def _relax_env(self, coords, z):
        """FIRE on the low level, per member of the batch (B, N, 3)."""
        if self.microiter <= 0:
            return coords
        n = coords.shape[1]
        mask = torch.ones((n, 1), dtype=coords.dtype, device=coords.device)
        mask[self.high_idx] = 0.0
        # torch.func.grad: the relaxation also runs inside the Hessian's
        # functorch transforms
        grad_low = torch.func.grad(
            lambda y: self.low_calc.energy(y, z).sum())
        x = coords.detach()
        v = torch.zeros_like(x)
        dt = torch.full((x.shape[0], 1, 1), self.micro_dt, dtype=x.dtype,
                        device=x.device)
        for _ in range(self.microiter):
            g = grad_low(x) * mask
            power = (-g * v).sum((-2, -1), keepdim=True)
            up = power > 0
            v = torch.where(up, 0.9 * v - dt * g, -dt * g)
            dt = torch.where(up, torch.clamp(dt * 1.05, max=0.8), dt * 0.5)
            x = x + dt * v
        return x

    def energy(self, coords, z):
        x = self._relax_env(coords, z)
        hi = torch.zeros((coords.shape[1], 1), dtype=torch.bool,
                         device=coords.device)
        hi[self.high_idx] = True
        return super().energy(torch.where(hi, coords, x.detach()), z)
