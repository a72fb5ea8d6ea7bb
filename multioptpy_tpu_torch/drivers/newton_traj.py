"""Growing Newton trajectory (GNT): a single-ended TS search.

Counterpart of `multioptpy_tpu/drivers/newton_traj.py`: follow the curve
along which the gradient stays parallel to a fixed search direction r
(Quapp's reduced-gradient following). Each frontier point takes a
predictor step along r, then a fixed number of corrector steps of
projected steepest descent on the gradient component perpendicular to r
(TR/rot projected out for molecules). r defaults to the reactant->product
difference vector (Kabsch-aligned) or an explicit direction. The frontier
stays on the device; the host reads one (energy, |g|, progress) triple per
point.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.geometry import align_to, project_gradient_tr_rot
from multioptpy_tpu_torch.ops import hosteval


@dataclasses.dataclass(frozen=True)
class GNTConfig:
    step_size: float = 0.1        # Bohr predictor step
    n_steps: int = 100
    n_corrector: int = 20
    corrector_rate: float = 0.5
    grad_threshold: float = 5e-4  # stationary-point detection on |g|


class GNTResult(NamedTuple):
    path: np.ndarray            # (S,N,3)
    energies: np.ndarray
    grad_norms: np.ndarray
    ts_guess: torch.Tensor      # highest-energy point on the trajectory
    ts_energy: float
    stationary_points: list     # indices where |g| dips below threshold


def newton_trajectory(calc, coords, z, direction=None, product_coords=None,
                      config=GNTConfig(), bias_engine=None, device=None):
    """Grow a Newton trajectory from `coords` (N,3) along `direction` (or
    toward `product_coords`) on `device` (None means the CUDA card)."""
    dev = calc_device(calc, device, "the trajectory")
    coords = on_device(coords, dev)
    # one-particle model surfaces have no TR/rot modes worth removing, and
    # projecting translations would annihilate the search direction
    internal = coords.shape[0] >= 2
    if product_coords is not None:
        product_coords = on_device(product_coords, dev).to(coords.dtype)
        if internal:
            product_coords = align_to(product_coords, coords)
    if direction is None:
        if product_coords is None:
            raise ValueError("give a direction vector or product_coords")
        direction = product_coords - coords
    r = on_device(direction, dev).to(coords.dtype).reshape(coords.shape)
    if internal:
        r = project_gradient_tr_rot(r[None], coords[None])[0]
    r = r.reshape(-1)
    r = r / (torch.linalg.vector_norm(r) + 1e-30)

    def energy_grad(x):
        e, g = hosteval.energy_and_gradient(calc, x[None], z, bias_engine)
        return e[0], g[0]

    def advance(x):
        x = x + (config.step_size * r).reshape(x.shape)
        for _ in range(config.n_corrector):
            _, g = energy_grad(x)
            g_int = (project_gradient_tr_rot(g[None], x[None])[0]
                     if internal else g)
            g_flat = g_int.reshape(-1)
            g_perp = g_flat - (g_flat @ r) * r
            x = x - (config.corrector_rate * g_perp).reshape(x.shape)
        e, g = energy_grad(x)
        return x, e, torch.linalg.vector_norm(g)

    n_steps = config.n_steps
    if product_coords is not None:
        dist = float(torch.linalg.vector_norm(
            (product_coords - coords).reshape(-1)))
        n_steps = min(n_steps, int(np.ceil(dist / config.step_size)) + 2)

    path = [coords]
    e0, g0 = energy_grad(coords)
    energies = [float(e0)]
    gnorms = [float(torch.linalg.vector_norm(g0))]
    x = coords
    stationary = []
    for i in range(1, n_steps + 1):
        x, e, gn = advance(x)
        path.append(x)
        past = ((x - product_coords).reshape(-1) @ r
                if product_coords is not None else torch.zeros_like(e))
        e, gn, past = torch.stack([e, gn, past]).tolist()   # one sync
        energies.append(e)
        gnorms.append(gn)
        if gn < config.grad_threshold:
            stationary.append(i)
        # a local maximum of the energy profile marks a crossed TS: stop
        # there in single-ended mode, keep growing toward a product
        if len(energies) >= 3 and energies[-3] < energies[-2] > energies[-1]:
            if i - 1 not in stationary:
                stationary.append(i - 1)
            if product_coords is None:
                break
        if len(energies) >= 3 and energies[-3] > energies[-2] < energies[-1]:
            if i - 1 not in stationary:
                stationary.append(i - 1)
        if product_coords is not None and past > 0:
            break  # walked past the product projection

    energies = np.asarray(energies)
    ts_idx = int(np.argmax(energies))
    return GNTResult(
        path=torch.stack(path).cpu().numpy(), energies=energies,
        grad_norms=np.asarray(gnorms), ts_guess=path[ts_idx],
        ts_energy=float(energies[ts_idx]), stationary_points=stationary)
