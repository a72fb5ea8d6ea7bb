"""2PSHS: two-point scaled hypersphere search (double-ended TS search).

Counterpart of `multioptpy_tpu/drivers/twopshs.py`: hyperspheres (in the
scaled coordinates of `drivers/addf.py`) grow from the reactant toward the
product; on each the energy plus a harmonic pull toward the product is
minimized on the sphere, seeded by the direction toward the product, and
the radius grows until the frontier's true energy turns over: the crossing
is the TS region.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.drivers.addf import (_energy_fn, _gradient_of,
                                               _harmonic_modes,
                                               relax_on_sphere)
from multioptpy_tpu_torch.geometry import align_to


@dataclasses.dataclass(frozen=True)
class TwoPSHSConfig:
    r_start: float = 0.3
    r_step: float = 0.15
    n_spheres: int = 60
    n_relax: int = 60
    relax_rate: float = 0.2
    eig_floor: float = 1e-4
    product_bias: float = 0.02   # Ha/Bohr^2: harmonic pull toward the
                                 # product during the on-sphere relaxation
                                 # (product-directed frontier growth); the
                                 # recorded energies and the turnover test
                                 # use the true energy


class TwoPSHSResult(NamedTuple):
    path: np.ndarray
    energies: np.ndarray
    ts_guess: np.ndarray
    ts_energy: float
    crossed_ts: bool


def twopshs(calc, reactant, product, z, config=TwoPSHSConfig(),
            bias_engine=None, device=None):
    """Grow product-directed spheres from the reactant minimum (N,3) on
    `device` (None means the CUDA card)."""
    dev = calc_device(calc, device, "the search")
    reactant = on_device(reactant, dev)
    product = on_device(product, dev).to(reactant.dtype)
    n = reactant.shape[0]
    energy = _energy_fn(calc, z, bias_engine)

    # vibrational subspace only (see drivers/addf.py)
    w, v, _ = _harmonic_modes(calc, reactant, z, bias_engine)
    w_np, v_np = w.cpu().numpy(), v.cpu().numpy()
    vib = w_np > config.eig_floor
    kind = dict(dtype=reactant.dtype, device=dev)
    v_vib = torch.as_tensor(v_np[:, vib], **kind)
    scale = torch.sqrt(torch.as_tensor(w_np[vib], **kind))

    # align the product onto the reactant frame (COM + Kabsch) so that the
    # target direction is vibrational; one-particle surfaces keep theirs
    if n >= 2:
        product = align_to(product, reactant)
    x0 = reactant.reshape(-1)

    def to_cart(q):
        return (x0 + v_vib @ (q / scale)).reshape(n, 3)

    def to_scaled(x):
        return scale * (v_vib.T @ (x.reshape(-1) - x0))

    def energy_q(q):
        return energy(to_cart(q))

    prod_flat = product.reshape(-1)

    def objective_q(q):
        x = to_cart(q).reshape(-1)
        return (energy_q(q) + 0.5 * config.product_bias
                * ((x - prod_flat) ** 2).sum())

    grad_q = _gradient_of(objective_q)
    q_prod = to_scaled(product)
    r_prod = float(torch.linalg.vector_norm(q_prod))
    seed_dir = q_prod / (torch.linalg.vector_norm(q_prod) + 1e-30)

    path = [reactant]
    energies = [float(energy(reactant).detach())]
    crossed = False
    r = config.r_start
    q = seed_dir * r
    while r < r_prod and len(path) <= config.n_spheres:
        q = relax_on_sphere(grad_q, q, r, config.n_relax, config.relax_rate)
        path.append(to_cart(q))
        energies.append(float(energy_q(q).detach()))     # one sync
        if len(energies) > 2 and energies[-1] < energies[-2]:
            crossed = True
            break
        r += config.r_step
        q = q * (r / torch.linalg.vector_norm(q))

    path = torch.stack(path).detach().cpu().numpy()
    energies = np.asarray(energies)
    ts_idx = int(np.argmax(energies))
    return TwoPSHSResult(path=path, energies=energies,
                         ts_guess=path[ts_idx],
                         ts_energy=float(energies[ts_idx]),
                         crossed_ts=crossed)
