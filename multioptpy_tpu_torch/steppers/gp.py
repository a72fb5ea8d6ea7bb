"""Gaussian-process surrogate stepper (GPmin), on batches.

Counterpart of `multioptpy_tpu/steppers/gp.py`: fit a gradient-enhanced RBF
GP to the optimization history (energies and gradients, a ring of the last
M observations) and step to the surrogate's minimum. The kernel blocks of
values and derivatives are written in closed form for the RBF kernel (the
reference takes them from `jax.grad`/`jacfwd` of the kernel); the descent
on the surrogate takes its gradient from `torch.autograd`. Every state
field has a leading batch axis B; the GP solve is batched.
"""

from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.steppers.first_order import ring_slot


class GpState(NamedTuple):
    x_hist: torch.Tensor   # (B, M, D)
    e_hist: torch.Tensor   # (B, M)
    g_hist: torch.Tensor   # (B, M, D)
    count: torch.Tensor    # (B,) int32


def gp_init(dim, history=8, dtype=torch.float64, device=None):
    return GpState(torch.zeros((history, dim), dtype=dtype, device=device),
                   torch.zeros((history,), dtype=dtype, device=device),
                   torch.zeros((history, dim), dtype=dtype, device=device),
                   torch.tensor(0, dtype=torch.int32, device=device))


def _rbf(x1, x2, ls):
    """exp(-|x1 - x2|^2 / (2 ls^2)) over the last axis."""
    return torch.exp(-0.5 * ((x1 - x2) ** 2).sum(-1) / ls ** 2)


def _gp_weights(state, lengthscale=1.0, noise=1e-8):
    """(e_mean (B,), alpha (B, M + M D)): the posterior weights of the
    history's values and gradients. Unused slots get a 1e6 nugget."""
    b, m, d = state.x_hist.shape
    ls2 = lengthscale ** 2
    x = state.x_hist
    valid = (torch.arange(m, device=x.device)
             < torch.clamp(state.count, max=m)[:, None])      # (B, M)
    diff = x[:, :, None, :] - x[:, None, :, :]              # a - b (B,M,M,D)
    k_vv = _rbf(x[:, :, None, :], x[:, None, :, :], lengthscale)
    k_vg = k_vv[..., None] * diff / ls2                     # dk/db
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    k_gg = k_vv[..., None, None] * (eye / ls2 - diff[..., :, None]
                                    * diff[..., None, :] / ls2 ** 2)
    n_total = m + m * d
    big = x.new_zeros((b, n_total, n_total))
    big[:, :m, :m] = k_vv
    big[:, :m, m:] = k_vg.reshape(b, m, m * d)
    big[:, m:, :m] = k_vg.reshape(b, m, m * d).mT
    big[:, m:, m:] = k_gg.permute(0, 1, 3, 2, 4).reshape(b, m * d, m * d)
    vmask = torch.cat([valid, valid.repeat_interleave(d, dim=1)], dim=1)
    nugget = torch.where(vmask, noise, 1e6).to(x.dtype)
    big = big + torch.diag_embed(nugget)
    e_mean = (torch.where(valid, state.e_hist, 0.0).sum(-1)
              / torch.clamp(valid.sum(-1), min=1))
    y = torch.cat([torch.where(valid, state.e_hist - e_mean[:, None], 0.0),
                   (state.g_hist * valid[..., None]).reshape(b, -1)], dim=1)
    return e_mean, torch.linalg.solve_ex(big, y)[0]


def _posterior(x_query, state, e_mean, alpha, lengthscale=1.0):
    """Posterior mean at x_query (B, D) from precomputed weights."""
    b, m, d = state.x_hist.shape
    diff = x_query[:, None, :] - state.x_hist                # a - b (B,M,D)
    k_q_v = _rbf(x_query[:, None, :], state.x_hist, lengthscale)
    k_q_g = (k_q_v[..., None] * diff / lengthscale ** 2).reshape(b, -1)
    k_q = torch.cat([k_q_v, k_q_g], dim=1)
    return e_mean + (k_q * alpha).sum(-1)


def gp_posterior_energy(x_query, state, lengthscale=1.0, noise=1e-8):
    """Gradient-enhanced GP posterior mean at x_query (B, D) -> (B,), from
    the values and gradients of the valid history points."""
    e_mean, alpha = _gp_weights(state, lengthscale, noise)
    return _posterior(x_query, state, e_mean, alpha, lengthscale)


def inv_dist_descriptor(n_atoms, dist_scale=1.0, min_dist=0.5):
    """Inverse-distance descriptor phi(x) = 1/(max(r_ij, min_dist) scale)
    over the upper-triangle pairs. Returns (phi_fn, P); phi_fn maps
    (B, 3N) -> (B, P)."""
    iu, ju = (torch.as_tensor(a) for a in np.triu_indices(n_atoms, k=1))

    def phi(x_flat):
        c = x_flat.reshape(x_flat.shape[0], n_atoms, 3)
        d = torch.linalg.vector_norm(c[:, iu] - c[:, ju], dim=-1)
        return 1.0 / (torch.clamp(d, min=min_dist) * dist_scale)

    return phi, len(iu)


def gp_step(state, x, energy, gradient, lengthscale=1.0, n_descent=30,
            rate=0.2, max_step=0.5, phi_fn=None):
    """Push the observation, then `n_descent` gradient-descent steps on the
    surrogate from x; return the move to where they end (clamped to
    `max_step`), or -rate * gradient while a row has < 2 observations.

    phi_fn: an optional descriptor map (`inv_dist_descriptor`); the GP is
    then fit in descriptor space, observed gradients transformed by the
    Jacobian least squares g_phi = (J J^T + 1e-10 I)^-1 J g_x. x, gradient
    (B, D), energy (B,)."""
    if phi_fn is None:
        obs_x, obs_g = x, gradient
    else:
        obs_x = phi_fn(x)
        jac = torch.func.vmap(torch.func.jacfwd(
            lambda xf: phi_fn(xf[None])[0]))(x)              # (B, P, D)
        eye = torch.eye(jac.shape[1], dtype=x.dtype, device=x.device)
        obs_g = torch.linalg.solve_ex(jac @ jac.mT + 1e-10 * eye,
                                      (jac @ gradient[..., None])[..., 0])[0]
    m = state.x_hist.shape[-2]
    slot = ring_slot(state.count, m)
    state = GpState(
        x_hist=torch.where(slot[..., None], obs_x[:, None], state.x_hist),
        e_hist=torch.where(slot, energy[:, None], state.e_hist),
        g_hist=torch.where(slot[..., None], obs_g[:, None], state.g_hist),
        count=state.count + 1)

    e_mean, alpha = _gp_weights(state, lengthscale)
    q = x
    for _ in range(n_descent):
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            feat = qq if phi_fn is None else phi_fn(qq)
            e = _posterior(feat, state, e_mean, alpha, lengthscale)
            (g_q,) = torch.autograd.grad(e.sum(), qq)
        q = q - rate * g_q
    move = q - x
    norm = torch.linalg.vector_norm(move, dim=-1, keepdim=True)
    move = torch.where(norm > max_step,
                       move * (max_step / torch.clamp(norm, min=1e-30)), move)
    move = torch.where((state.count >= 2)[:, None], move, -rate * gradient)
    return move, state
