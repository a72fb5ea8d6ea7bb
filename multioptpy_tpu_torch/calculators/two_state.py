"""Two-state model functions as composite calculators on batched
coordinates.

Counterpart of `multioptpy_tpu/calculators/two_state.py`. A model function
combines two surfaces E1(x), E2(x) into one scalar, so each is a
`Calculator` wrapping two state calculators and the whole optimization
stack runs on it unchanged; the gradients come from autograd. Both states
see the whole batch in one call each.

  seam       0.5 (E1+E2) + (E1-E2)^2 / alpha
  avoiding   0.5 (E1+E2) + 0.5 sqrt((E1-E2)^2 + 4 U)
  conical    0.5 (E1+E2) + sigma dE^2 / (|dE| + alpha)
  meci       the same penalty form as conical
  mesx       0.5 (E1+E2) + kappa dE^2
  mesx2      gradient projection: the energy is 0.5 (E1+E2) and the force
             is composed, 2 (E1-E2) v + (I - v v^T) g_mean with
             v = (g1-g2)/|g1-g2|, so energy_and_gradient and hessian are
             written out instead of differentiated

BITSS (binary-image TS search) couples two geometries: `BITSSCalculator`
acts on a 2N-atom super-system.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   composite_hessian)


class TwoStateModelFunction(Calculator):
    """Combine two calculators' surfaces with a model function; lives on
    calc_1's device."""

    on_device = True

    def __init__(self, calc_1, calc_2, kind="seam", alpha=0.02, sigma=3.5,
                 coupling=1e-3, kappa=10.0, **kw):
        kw.setdefault("device", calc_1.device)
        super().__init__(**kw)
        self.calc_1 = calc_1
        self.calc_2 = calc_2
        self.kind = kind
        self.alpha = float(alpha)
        self.sigma = float(sigma)
        self.coupling = float(coupling)
        self.kappa = float(kappa)
        self.on_device = calc_1.on_device and calc_2.on_device

    def energy(self, coords, z):
        e1 = self.calc_1.energy(coords, z)
        e2 = self.calc_2.energy(coords, z)
        de = e1 - e2
        mean = 0.5 * (e1 + e2)
        if self.kind == "seam":
            return mean + de ** 2 / self.alpha
        if self.kind == "avoiding":
            return mean + 0.5 * torch.sqrt(de ** 2 + 4.0 * self.coupling)
        if self.kind in ("conical", "meci"):
            return mean + self.sigma * de ** 2 / (de.abs() + self.alpha)
        if self.kind == "mesx":
            return mean + self.kappa * de ** 2
        if self.kind == "mesx2":
            # the tracked objective is the mean energy; descent comes from
            # the composed force of energy_and_gradient
            return mean
        raise ValueError(f"unknown model function '{self.kind}'")

    @staticmethod
    def _gp_vector(g1, g2):
        """(B, 3N) unit difference-gradient vectors (zero where |dg| is
        below 1e-8)."""
        dg = (g1 - g2).reshape(g1.shape[0], -1)
        nrm = torch.linalg.vector_norm(dg, dim=-1, keepdim=True)
        return torch.where(nrm > 1e-8, dg / nrm.clamp(min=1e-30),
                           torch.zeros_like(dg))

    def energy_and_gradient(self, coords, z):
        if self.kind != "mesx2":
            return super().energy_and_gradient(coords, z)
        # gap restoration along the difference-gradient vector plus the
        # seam force in its orthogonal complement
        e1, g1 = self.calc_1.energy_and_gradient(coords, z)
        e2, g2 = self.calc_2.energy_and_gradient(coords, z)
        v = self._gp_vector(g1, g2)
        g_mean = (0.5 * (g1 + g2)).reshape(v.shape)
        gp = (2.0 * (e1 - e2)[:, None] * v
              + (g_mean - v * (v * g_mean).sum(-1, keepdim=True)))
        return 0.5 * (e1 + e2), gp.reshape(coords.shape)

    def hessian(self, coords, z):
        if self.kind != "mesx2":
            return composite_hessian(self, coords, z)
        # P H_mean P + 2 v v^T
        g1 = self.calc_1.gradient(coords, z)
        g2 = self.calc_2.gradient(coords, z)
        v = self._gp_vector(g1, g2)
        h_mean = 0.5 * (self.calc_1.hessian(coords, z)
                        + self.calc_2.hessian(coords, z))
        hv = (h_mean @ v[..., None])[..., 0]
        vv = v[:, :, None] * v[:, None, :]
        p_h_p = (h_mean - v[:, :, None] * hv[:, None, :]
                 - hv[:, :, None] * v[:, None, :]
                 + vv * (v * hv).sum(-1)[:, None, None])
        return p_h_p + 2.0 * vv

    def gap(self, coords, z):
        return self.calc_1.energy(coords, z) - self.calc_2.energy(coords, z)


class BITSSCalculator(Calculator):
    """Binary-image TS search on a 2N-atom super-system:

    E(x1, x2) = E(x1) + E(x2) + kappa_e (E1-E2)^2 + kappa_d (|x1-x2| - d)^2

    The target distance d contracts by `shrink` per `contract()` call,
    which `bitss_search` makes between optimization stages. `energy` takes
    a batch (B, 2N, 3); `contract` and `update_kappas` take the one
    super-structure (2N, 3) of the optimization."""

    on_device = True

    def __init__(self, calc, n_atoms, kappa_e=10.0, kappa_d=1.0, d0=None,
                 shrink=0.5, **kw):
        kw.setdefault("device", calc.device)
        super().__init__(**kw)
        self.calc = calc
        self.n_atoms = int(n_atoms)
        self.kappa_e = float(kappa_e)
        self.kappa_d = float(kappa_d)
        self.d_target = d0
        self.shrink = float(shrink)
        self.on_device = calc.on_device
        self._e_b0 = None

    @staticmethod
    def pack(coords_1, coords_2):
        return torch.cat([coords_1, coords_2], dim=-2)

    def unpack(self, coords):
        return coords[..., : self.n_atoms, :], coords[..., self.n_atoms:, :]

    def pack_z(self, z):
        z = np.asarray(z)
        return np.concatenate([z, z])

    def contract(self, coords):
        """Shrink the pair-distance target."""
        x1, x2 = self.unpack(coords)
        current = float(torch.linalg.vector_norm(x1 - x2))
        base = current if self.d_target is None else min(self.d_target,
                                                         current)
        self.d_target = max((1.0 - self.shrink) * base, 1e-6)
        return self.d_target

    def update_kappas(self, coords, z, alpha=10.0, beta=0.02):
        """Adaptive constraint strengths (BITSS eqs. 4-5):
        kappa_e = alpha / (2 E_B), kappa_d = max(|grad_proj| /
        (2^1.5 beta d), E_B / (beta d^2)), with E_B floored at 5 % of its
        first value so that kappa_e stays finite as the images
        equalize."""
        x1, x2 = self.unpack(torch.as_tensor(coords))
        z1 = np.asarray(z)[: self.n_atoms]
        e1, g1 = self.calc.energy_and_gradient(x1[None], z1)
        e2, g2 = self.calc.energy_and_gradient(x2[None], z1)
        diff = x1 - x2
        dist = float(torch.linalg.vector_norm(diff)) + 1e-10
        unit = diff / dist
        e_b = abs(float(e1[0] - e2[0])) + 1e-10
        if self._e_b0 is None:
            self._e_b0 = e_b
        e_b = max(e_b, 0.05 * self._e_b0)
        proj1 = float((g1[0] * (-unit)).sum())
        proj2 = float((g2[0] * unit).sum())
        grad_term = np.sqrt(proj1 ** 2 + proj2 ** 2)
        self.kappa_e = alpha / (2.0 * e_b)
        self.kappa_d = max(grad_term / (2.0 ** 1.5 * beta * dist + 1e-10),
                           e_b / (beta * dist ** 2 + 1e-10))
        return self.kappa_e, self.kappa_d

    def hessian(self, coords, z):
        return composite_hessian(self, coords, z)

    def energy(self, coords, z):
        x1, x2 = self.unpack(coords)
        z1 = np.asarray(z)[: self.n_atoms]
        e1 = self.calc.energy(x1, z1)
        e2 = self.calc.energy(x2, z1)
        dist = torch.sqrt(((x1 - x2) ** 2).sum((-2, -1)) + 1e-14)
        d_tgt = self.d_target if self.d_target is not None else dist
        return (e1 + e2 + self.kappa_e * (e1 - e2) ** 2
                + self.kappa_d * (dist - d_tgt) ** 2)


def bitss_search(calc, coords_a, coords_b, z, n_stages=8, opt_config=None,
                 kappa_e=50.0, kappa_d=2.0, shrink=0.4):
    """The BITSS loop on calc's device: alternate distance contraction and
    pair relaxation until the images meet at the saddle region. Returns
    (ts_guess (N, 3), energy)."""
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize

    opt_config = opt_config or OptimizeConfig(
        method="fire", nsteps=150, max_force=1e-5, rms_force=7e-6,
        project_tr_rot=False)
    n = coords_a.shape[0]
    bitss = BITSSCalculator(calc, n, kappa_e=kappa_e, kappa_d=kappa_d,
                            shrink=shrink)
    dev = calc.device
    coords = BITSSCalculator.pack(
        torch.as_tensor(coords_a, dtype=torch.float64, device=dev),
        torch.as_tensor(coords_b, dtype=torch.float64, device=dev))
    zz = bitss.pack_z(z)
    for _ in range(n_stages):
        bitss.update_kappas(coords, z)
        bitss.contract(coords)
        coords = optimize(bitss, coords, zz, config=opt_config,
                          device=dev).coords
    x1, x2 = bitss.unpack(coords)
    mid = 0.5 * (x1 + x2)
    e_mid = float(calc.energy(mid[None], np.asarray(z))[0])
    return mid, e_mid


def optimize_model_function(calc_1, calc_2, coords, z, kind="seam",
                            opt_config=None, **mf_kwargs):
    """Build the model-function calculator and minimize it on calc_1's
    device. Returns (OptResult, TwoStateModelFunction), so that the
    caller can inspect the gap."""
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize

    mf = TwoStateModelFunction(calc_1, calc_2, kind=kind, **mf_kwargs)
    opt_config = opt_config or OptimizeConfig(
        method="rfo_fsb", nsteps=200,
        fc_count=5 if mf.on_device else -1, project_tr_rot=False)
    res = optimize(mf, coords, z, config=opt_config, device=mf.device)
    return res, mf
