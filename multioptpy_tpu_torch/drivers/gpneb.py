"""GPNEB: Gaussian-process-accelerated NEB on one device.

Counterpart of `multioptpy_tpu/drivers/gpneb.py` (Koistinen et al., JCP 147
(2017) 152720): true energies and gradients of the band are evaluated once
per outer round, as one batched calculator call; between evaluations the
whole band relaxes for `n_inner` FIRE steps on the gradient-enhanced GP
surrogate of `steppers/gp.py`, with the improved-tangent NEB force and the
surrogate's gradient from autograd. The GP's weights are solved once per
round (the history does not change while the band relaxes on it). The
image-sharded variant (`mesh`) belongs to ROADMAP Queue 1 item 17.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.drivers.neb import neb_forces
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.steppers.first_order import fire_init, fire_step
from multioptpy_tpu_torch.steppers.gp import GpState, _gp_weights, _rbf


@dataclasses.dataclass(frozen=True)
class GPNEBConfig:
    n_outer: int = 6             # true-evaluation rounds
    n_inner: int = 60            # surrogate NEB steps per round
    k_spring: float = 0.01
    lengthscale: float = 1.0
    dt0: float = 0.1
    dt_max: float = 0.4
    fmax: float = 5e-4
    max_history: int = 96        # GP observation budget


class GPNEBResult(NamedTuple):
    path: torch.Tensor
    energies: torch.Tensor
    converged: bool
    n_true_evaluations: int
    ts_index: int


def _surrogate_eg(path, gp, e_mean, alpha, lengthscale):
    """Posterior mean energies (I,) and their gradients (I,N,3) for every
    image of `path` from one GP (history (1, M, D), weights `alpha`)."""
    n_img = path.shape[0]
    x_hist = gp.x_hist[0]
    with torch.enable_grad():
        q = path.detach().reshape(n_img, -1).requires_grad_(True)
        diff = q[:, None, :] - x_hist[None]
        k_v = _rbf(q[:, None, :], x_hist[None], lengthscale)
        k_g = (k_v[..., None] * diff / lengthscale ** 2).reshape(n_img, -1)
        e = e_mean[0] + torch.cat([k_v, k_g], dim=1) @ alpha[0]
        (g,) = torch.autograd.grad(e.sum(), q)
    return e.detach(), g.reshape(path.shape)


def gpneb(calc, path0, z, config=GPNEBConfig(), bias_engine=None,
          mesh=None, mesh_axis="batch", device=None):
    """Run GP-accelerated NEB on an (I,N,3) initial path. `device` (None
    means the CUDA card) must be where `calc` lives.

    The surrogate solve is a (M + M D)-square system with a 1e-8 nugget,
    conditioned up to ~1e8, so it amplifies rounding: on the CPU the port
    follows the reference to 1e-9 Bohr and 1e-10 Ha after its rounds
    (tests/test_torch_gpneb.py; measured 2.7e-11 Bohr on Muller-Brown). A
    card run is held to its CPU rerun with the same bound."""
    del mesh_axis
    if mesh is not None:
        raise NotImplementedError(
            "the image-sharded GPNEB (mesh) arrives with ROADMAP Queue 1 "
            "item 17")
    dev = calc_device(calc, device, "GPNEB")
    path = on_device(path0, dev)
    n_images, n_atoms, _ = path.shape
    d = n_atoms * 3
    kind = dict(dtype=path.dtype, device=dev)
    m = config.max_history
    gp = GpState(torch.zeros((1, m, d), **kind), torch.zeros((1, m), **kind),
                 torch.zeros((1, m, d), **kind),
                 torch.zeros(1, dtype=torch.int32, device=dev))
    count = 0

    n_true = 0
    converged = False
    energies = None
    for _ in range(config.n_outer):
        energies, grads = hosteval.energy_and_gradient(calc, path, z,
                                                       bias_engine)
        n_true += n_images
        fmax = float(neb_forces(path, energies, grads, config.k_spring,
                                "neb").abs().max())
        if fmax < config.fmax:
            converged = True
            break
        # push the band's observations into the ring, image by image
        x_hist, e_hist, g_hist = (t.clone() for t in gp[:3])
        for i in range(n_images):
            slot = count % m
            x_hist[0, slot] = path[i].reshape(-1)
            e_hist[0, slot] = energies[i]
            g_hist[0, slot] = grads[i].reshape(-1)
            count += 1
        gp = GpState(x_hist, e_hist, g_hist,
                     torch.full((1,), count, dtype=torch.int32, device=dev))
        e_mean, alpha = _gp_weights(gp, config.lengthscale)
        fire = fire_init(path.numel(), path.dtype, dt0=config.dt0, device=dev)
        for _ in range(config.n_inner):
            es, gs = _surrogate_eg(path, gp, e_mean, alpha,
                                   config.lengthscale)
            forces = neb_forces(path, es, gs, config.k_spring, "neb")
            move, fire = fire_step(fire, -forces.reshape(-1),
                                   dt_max=config.dt_max)
            path = path + move.reshape(path.shape)

    if energies is None:
        energies, _ = hosteval.energy_and_gradient(calc, path, z,
                                                   bias_engine)
    e_np = energies.detach().cpu().numpy()
    ts_index = int(np.argmax(e_np[1:-1])) + 1 if n_images > 2 else 0
    return GPNEBResult(path=path, energies=energies, converged=converged,
                       n_true_evaluations=n_true, ts_index=ts_index)
