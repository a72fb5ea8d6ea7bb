"""NEB: nudged elastic band with the whole path as one batched tensor.

Counterpart of `multioptpy_tpu/drivers/neb.py` on one device. The path is
an (I, N, 3) tensor, and the band's energies and gradients are ONE batched
calculator call over the I images; tangents, springs and projections are
whole-band tensor ops. Endpoint images are frozen unless asked to relax.

Force laws (`variant`): neb (improved tangents, Henkelman & Jonsson, JCP
113 (2000) 9978), cineb (+ climbing image, JCP 113 (2000) 9901), dneb
(doubly nudged, Trygubenko & Wales, JCP 120 (2004) 2082), lup, qsm and
string (perpendicular gradient; qsm/string respace every iteration), om
(energy-weighted springs), qsm2 (Ayala-Schlegel propagated tangents, JCP
107 (1997) 375), the per-atom Wilson-B family bneb, bneb2, bneb3, nesb and
ewbneb (energy-weighted springs, Asgeirsson et al., JCTC 17 (2021) 4929),
dmf (direct MaxFlux) and gpneb (the spring law; the surrogate-accelerated
driver is `drivers/gpneb.py`).

Band clocks (`NEBConfig.optimizer`): fire, afire (per-image FIRE clocks),
quickmin, sd, lbfgs and cg_{pr,fr,hs,dy,hz} (the whole band as one vector:
the batched first-order engines with B = 1), and rfo (FIRE blended with a
per-image RS-RFO on FSB/Bofill Hessians).

Initial paths: linear and IDPP (Smidstrup et al., JCP 140 (2014) 214106).
The sharded band (`neb_sharded`, `aneb_sharded`) belongs to ROADMAP Queue 1
item 17.
"""

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import (calc_device, on_device,
                                         resolve_device)
from multioptpy_tpu_torch.interpolation import (linear_resample,
                                                redistribute_path)
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.steppers.first_order import (FireState, cg_init,
                                                       cg_step, fire_init,
                                                       fire_step, lbfgs_init,
                                                       lbfgs_step)

VARIANTS = ("neb", "cineb", "dneb", "lup", "om", "qsm", "qsm2", "string",
            "bneb", "bneb2", "bneb3", "nesb", "dmf", "ewbneb", "gpneb")
OPTIMIZERS = ("fire", "afire", "quickmin", "lbfgs", "sd", "rfo", "cg_pr",
              "cg_fr", "cg_hs", "cg_dy", "cg_hz")


def _image_dot(a, b):
    """Per-image inner product: (I,N,3)x(I,N,3) -> (I,1,1)."""
    return (a * b).sum((-1, -2), keepdim=True)


def _normalize(v, eps=1e-14):
    return v / torch.sqrt(_image_dot(v, v) + eps)


def _halo_weights(e, e_prev, e_next):
    """(uphill, downhill, w_plus, w_minus) of the improved tangent."""
    uphill = (e_next > e) & (e > e_prev)
    downhill = (e_next < e) & (e < e_prev)
    de_max = torch.maximum((e_next - e).abs(), (e_prev - e).abs())
    de_min = torch.minimum((e_next - e).abs(), (e_prev - e).abs())
    next_higher = e_next > e_prev
    w_plus = torch.where(next_higher, de_max, de_min)[:, None, None]
    w_minus = torch.where(next_higher, de_min, de_max)[:, None, None]
    return uphill[:, None, None], downhill[:, None, None], w_plus, w_minus


def _tangents_from_halo(coords, x_prev, x_next, e, e_prev, e_next):
    """Improved tangents given explicit +-1 neighbor halos."""
    d_plus = x_next - coords
    d_minus = coords - x_prev
    up, down, w_p, w_m = _halo_weights(e, e_prev, e_next)
    tau = torch.where(up, d_plus,
                      torch.where(down, d_minus, w_p * d_plus + w_m * d_minus))
    return _normalize(tau)


def _rolled(coords, energies):
    return (torch.roll(coords, 1, 0), torch.roll(coords, -1, 0), energies,
            torch.roll(energies, 1), torch.roll(energies, -1))


def improved_tangents(coords, energies):
    """(I,N,3),(I,) -> unit tangents (I,N,3), Henkelman improved tangent."""
    x_prev, x_next, e, e_prev, e_next = _rolled(coords, energies)
    return _tangents_from_halo(coords, x_prev, x_next, e, e_prev, e_next)


def _per_atom_tangents(coords, energies):
    """Per-atom unit tangents (I,N,3): the Wilson-B rows of the inter-image
    per-atom-distance internals, bisection-weighted like the improved
    tangent."""
    x_prev, x_next, e, e_prev, e_next = _rolled(coords, energies)
    return _per_atom_tangents_from_halo(coords, x_prev, x_next, e, e_prev,
                                        e_next)


def _per_atom_tangents_from_halo(coords, x_prev, x_next, e, e_prev, e_next):
    """Per-atom tangents given explicit +-1 halos."""
    d_plus = x_next - coords
    d_minus = coords - x_prev
    up, down, w_p, w_m = _halo_weights(e, e_prev, e_next)
    t_atom = torch.where(up, d_plus,
                         torch.where(down, d_minus,
                                     w_p * d_plus + w_m * d_minus))
    t_norm = torch.sqrt((t_atom * t_atom).sum(-1, keepdim=True) + 1e-14)
    return t_atom / t_norm


def _nrm(v):
    return v / (torch.linalg.vector_norm(v) + 1e-30)


def _ayala_propagate(q_cur, q_uphill, t_up):
    """Arc (small turning angle) or parabola extrapolation of the uphill
    neighbour's tangent (Ayala & Schlegel eqs. 3c-3d)."""
    chord = q_cur - q_uphill
    chord_u = _nrm(chord)
    theta = torch.arccos(torch.clamp(chord_u @ t_up, -1.0, 1.0))
    denom = 2.0 * (t_up @ chord)
    safe = denom.abs() > 1e-10
    r = (chord @ chord) / torch.where(safe, denom, 1.0)
    r_safe = torch.where(r.abs() > 1e-10, r, 1.0)
    t_arc = torch.where(safe, _nrm(chord / r_safe - t_up), chord_u)
    n_vec = _nrm(chord - (chord @ t_up) * t_up)
    tan_v = torch.tan(theta - torch.pi / 4.0)
    t_par = _nrm(n_vec - tan_v * (t_up - n_vec))
    return torch.where(theta <= torch.pi / 4.0, t_arc, t_par)


def ayala_tangents(coords, energies):
    """Ayala-Schlegel path tangents (JCP 107 (1997) 375 eqs. 3a-3d): the
    tangent at the highest interior image comes from the weighted
    difference of its neighbours, then propagates downhill to each side.
    The peak index is read on the host; each side is a loop over its
    images. Returns unit tangents (I,N,3), endpoints zero."""
    n = coords.shape[0]
    flat = coords.reshape(n, -1)
    ts = int(torch.argmax(energies[1:-1])) + 1
    v_prev = flat[ts - 1] - flat[ts]
    v_next = flat[ts + 1] - flat[ts]
    t_ts = _nrm(v_next / torch.clamp(v_next @ v_next, min=1e-10)
                - v_prev / torch.clamp(v_prev @ v_prev, min=1e-10))
    tau = [torch.zeros_like(t_ts) for _ in range(n)]
    tau[ts] = t_ts
    t_up = t_ts
    for i in range(ts - 1, 0, -1):
        t_up = tau[i] = _ayala_propagate(flat[i], flat[i + 1], t_up)
    t_up = t_ts
    for i in range(ts + 1, n - 1):
        t_up = tau[i] = _ayala_propagate(flat[i], flat[i - 1], t_up)
    return torch.stack(tau).reshape(coords.shape)


@functools.lru_cache(maxsize=None)
def _dmf_weights(n_images, k):
    """Static linear-interpolation matrix of the k-fold subdivided path."""
    t_img = np.linspace(0.0, 1.0, n_images)
    t_ref = np.linspace(0.0, 1.0, k * (n_images - 1) + 1)
    w_mat = np.zeros((len(t_ref), n_images))
    for r, t in enumerate(t_ref):
        j = min(int(t * (n_images - 1)), n_images - 2)
        a = (t - t_img[j]) * (n_images - 1)
        w_mat[r, j] = 1.0 - a
        w_mat[r, j + 1] = a
    return w_mat


def _dmf_force(coords, energies, gradients, beta, nsegs):
    """Direct MaxFlux: -dA/dx / (beta A) of the action A = int exp(beta E)
    dl on the nsegs-fold subdivided path (energies shifted by their max);
    dA/dx is the geometric part plus dA/dE chained through the per-image
    gradients, both by autograd."""
    n_images = coords.shape[0]
    w_mat = torch.as_tensor(_dmf_weights(n_images, max(int(nsegs), 1)),
                            dtype=coords.dtype, device=coords.device)
    with torch.enable_grad():
        flat = coords.detach().reshape(-1).requires_grad_(True)
        e_shift = (energies - energies.max()).detach().requires_grad_(True)
        x_r = w_mat @ flat.reshape(n_images, -1)
        w_r = torch.exp(beta * (w_mat @ e_shift))
        seg = x_r[1:] - x_r[:-1]
        seg_len = torch.sqrt((seg ** 2).sum(-1) + 1e-14)
        action = (0.5 * (w_r[:-1] + w_r[1:]) * seg_len).sum() + 1e-30
        geo_grad, da_de = torch.autograd.grad(action, (flat, e_shift))
    da_dx = geo_grad.reshape(coords.shape) + da_de[:, None, None] * gradients
    return -da_dx / (beta * action.detach())


def _spacing_penalty_grad(coords, k=0.05):
    """Gradient of 0.5 k sum_j (L_j - L_{j-1})^2 over the segment lengths."""
    with torch.enable_grad():
        path = coords.detach().requires_grad_(True)
        seg = path[1:] - path[:-1]
        ell = torch.sqrt((seg ** 2).sum((1, 2)) + 1e-14)
        (g,) = torch.autograd.grad(0.5 * k * ((ell[1:] - ell[:-1]) ** 2).sum(),
                                   path)
    return g


def neb_forces(coords, energies, gradients, k_spring=0.01, variant="neb",
               climbing=False, optimize_endpoints=False, dmf_beta=10.0,
               dmf_nsegs=4):
    """Whole-path NEB force (I,N,3) for one of `VARIANTS`. `climbing`
    switches the climbing image on the highest interior image. Endpoints
    get -g when relaxed, else zero."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown NEB variant '{variant}' "
                         f"(choose from {', '.join(VARIANTS)})")
    n_images = coords.shape[0]
    tau = improved_tangents(coords, energies)
    g = gradients
    g_par = _image_dot(g, tau) * tau
    g_perp = g - g_par
    x_prev = torch.roll(coords, 1, 0)
    x_next = torch.roll(coords, -1, 0)
    d_plus_n = torch.sqrt(_image_dot(x_next - coords, x_next - coords)
                          + 1e-14)
    d_minus_n = torch.sqrt(_image_dot(coords - x_prev, coords - x_prev)
                           + 1e-14)

    if variant in ("bneb", "nesb", "ewbneb"):
        # per-atom perpendicular gradient (Wilson-B tangent space)
        t_atom = _per_atom_tangents(coords, energies)
        force = -(g - (g * t_atom).sum(-1, keepdim=True) * t_atom)
        dp_n = torch.sqrt(((x_next - coords) ** 2).sum(-1, keepdim=True)
                          + 1e-14)
        dm_n = torch.sqrt(((coords - x_prev) ** 2).sum(-1, keepdim=True)
                          + 1e-14)
        if variant == "nesb":
            force = force + k_spring * (dp_n - dm_n) * t_atom
        elif variant == "ewbneb":
            # stiff springs near the barrier, soft ones low down
            k_u, k_l = 0.005, 1e-4
            e_seg = torch.maximum(energies[:-1], energies[1:])
            e_max = energies.max()
            e_ref = torch.maximum(energies[0], energies[-1])
            denom = torch.clamp(e_max - e_ref, min=1e-12)
            k_seg = torch.where(e_seg > e_ref,
                                k_u - (k_u - k_l) * (e_max - e_seg) / denom,
                                k_l)
            k_fwd = torch.cat([k_seg, k_seg[-1:]])[:, None, None]
            k_bwd = torch.cat([k_seg[:1], k_seg])[:, None, None]
            force = force + (k_fwd * dp_n - k_bwd * dm_n) * t_atom
    elif variant == "bneb2":
        # per-atom projection off both neighbour directions (2x2 Gram
        # solve), then off the per-atom chord
        u1 = x_prev - coords
        u1 = u1 / (torch.sqrt((u1 ** 2).sum(-1, keepdim=True)) + 1e-15)
        u2 = x_next - coords
        u2 = u2 / (torch.sqrt((u2 ** 2).sum(-1, keepdim=True)) + 1e-15)
        c12 = (u1 * u2).sum(-1)
        g1 = (g * u1).sum(-1)
        g2 = (g * u2).sum(-1)
        det = 1.0 - c12 ** 2
        safe = det.abs() > 1e-10
        det_s = torch.where(safe, det, 1.0)
        a1 = torch.where(safe, (g1 - c12 * g2) / det_s, g1)
        a2 = torch.where(safe, (g2 - c12 * g1) / det_s, 0.0)
        g_p = g - a1[..., None] * u1 - a2[..., None] * u2
        uc = x_next - x_prev
        uc = uc / (torch.sqrt((uc ** 2).sum(-1, keepdim=True)) + 1e-15)
        force = -(g_p - (g_p * uc).sum(-1, keepdim=True) * uc)
    elif variant == "bneb3":
        # per-atom projection + equal-spacing image springs
        t_atom = _per_atom_tangents(coords, energies)
        force = -(g - (g * t_atom).sum(-1, keepdim=True) * t_atom)
        force = force - _spacing_penalty_grad(coords)
    elif variant == "qsm2":
        tau = ayala_tangents(coords, energies)
        g_par = _image_dot(g, tau) * tau
        force = -(g - g_par)
    elif variant == "dmf":
        force = _dmf_force(coords, energies, gradients, dmf_beta, dmf_nsegs)
    elif variant in ("lup", "qsm", "string"):
        force = -g_perp
    elif variant == "om":
        e_w = 1.0 + (energies - energies.min()) / (
            energies.max() - energies.min() + 1e-12)
        k_i = (k_spring * e_w)[:, None, None]
        force = -g_perp + k_i * (d_plus_n - d_minus_n) * tau
    else:
        force = -g_perp + k_spring * (d_plus_n - d_minus_n) * tau
        if variant == "dneb":
            # the perpendicular spring less its part along the
            # perpendicular gradient
            f_spring_full = k_spring * ((x_next - coords) - (coords - x_prev))
            f_s_perp = f_spring_full - _image_dot(f_spring_full, tau) * tau
            g_perp_hat = _normalize(g_perp)
            force = force + f_s_perp - _image_dot(f_s_perp,
                                                  g_perp_hat) * g_perp_hat

    idx = torch.arange(n_images, device=coords.device)
    interior = (idx > 0) & (idx < n_images - 1)
    if climbing:
        ci_idx = torch.argmax(torch.where(interior, energies, -torch.inf))
        is_ci = (idx == ci_idx)[:, None, None]
        force = torch.where(is_ci, -g + 2.0 * g_par, force)
    end_force = -g if optimize_endpoints else torch.zeros_like(g)
    return torch.where(~interior[:, None, None], end_force, force)


# --------------------------------------------------------------------------
# initial paths and insertions
# --------------------------------------------------------------------------

def interpolate_linear(start, end, n_images):
    """(N,3),(N,3) -> (I,N,3) linear interpolation including endpoints."""
    t = torch.as_tensor(np.linspace(0.0, 1.0, n_images), dtype=start.dtype,
                        device=start.device)[:, None, None]
    return (1.0 - t) * start[None] + t * end[None]


def _pair_distances(x):
    """(..., N, 3) -> (..., N, N) distances sqrt(|d|^2 + 1e-12)."""
    d = x[..., :, None, :] - x[..., None, :, :]
    return torch.sqrt((d * d).sum(-1) + 1e-12)


def _idpp_gradient(x, d_tgt, offdiag):
    """Gradient of 0.5 sum_{i<j} d^-4 (d - d_tgt)^2 for (..., N, 3)."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    d = torch.sqrt((diff * diff).sum(-1) + 1e-12)
    u = d - d_tgt
    # dE/dd of each pair, halved: every pair is counted from both atoms
    de_dd = torch.where(offdiag, 0.5 * (2.0 * u / d ** 4
                                        - 4.0 * u * u / d ** 5), 0.0)
    return ((de_dd / d)[..., None] * diff).sum(-2)


def _damped_relax(x, grad_fn, n_steps, dt):
    """The reference's damped dynamics with one shared clock."""
    v = torch.zeros_like(x)
    for _ in range(n_steps):
        g = grad_fn(x)
        power = (-g * v).sum()
        v = torch.where(power > 0, 0.9 * v - dt * g, -dt * g)
        x = x + dt * v
    return x


def idpp_path(start, end, n_images, n_steps=300, dt_scale=0.05):
    """IDPP initial path: relax each interior image of the linear path on
    the image-dependent pair potential sum_{i<j} w_ij (d_ij - d_ij^t)^2,
    w = d^-4, with d^t interpolated between the endpoints' distances
    (`n_steps` damped-dynamics steps over the whole band, on device)."""
    path0 = interpolate_linear(start, end, n_images)
    n = start.shape[0]
    offdiag = ~torch.eye(n, dtype=torch.bool, device=start.device)
    t = torch.as_tensor(np.linspace(0.0, 1.0, n_images), dtype=start.dtype,
                        device=start.device)[:, None, None]
    d_target = ((1 - t) * _pair_distances(start)[None]
                + t * _pair_distances(end)[None])
    idx = torch.arange(n_images, device=start.device)
    interior = ((idx > 0) & (idx < n_images - 1))[:, None, None]

    def grad_fn(path):
        return torch.where(interior, _idpp_gradient(path, d_target, offdiag),
                           0.0)

    return _damped_relax(path0, grad_fn, n_steps, dt_scale)


def _idpp_refine_middle(a, m, b, n_steps=200, dt_scale=0.05):
    """Relax the middle geometry of a 3-image path on the IDPP objective
    with the mean of the endpoints' distance matrices as the target."""
    n = a.shape[0]
    offdiag = ~torch.eye(n, dtype=torch.bool, device=a.device)
    d_tgt = 0.5 * (_pair_distances(a) + _pair_distances(b))
    return _damped_relax(m, lambda x: _idpp_gradient(x, d_tgt, offdiag),
                         n_steps, dt_scale)


def spline_climbing_insert(path, energies):
    """The reference's '-ci' climbing image: a natural cubic spline of the
    energy over the COM-aligned arc length, its local maxima from the roots
    of each segment's derivative, and for each maximum inside segment
    (i, i+1) with 2 <= i < I-2 image i replaced by the IDPP-refined linear
    interpolation at the maximum. Host-side numpy and a small IDPP relax;
    returns the new path."""
    p = path.detach().cpu().numpy()
    e = np.asarray(energies.detach().cpu().numpy()
                   if isinstance(energies, torch.Tensor) else energies,
                   dtype=np.float64)
    n = p.shape[0]
    if n < 5:
        return path
    centered = p - p.mean(axis=1, keepdims=True)
    seg = np.sqrt(((centered[1:] - centered[:-1]) ** 2).sum(axis=(1, 2)))
    s = np.concatenate([[0.0], np.cumsum(seg)])
    h = np.diff(s)
    if np.any(h < 1e-12):
        return path
    a_mat = np.zeros((n, n))
    rhs = np.zeros(n)
    a_mat[0, 0] = a_mat[-1, -1] = 1.0
    for i in range(1, n - 1):
        a_mat[i, i - 1] = h[i - 1]
        a_mat[i, i] = 2.0 * (h[i - 1] + h[i])
        a_mat[i, i + 1] = h[i]
        rhs[i] = 3.0 * ((e[i + 1] - e[i]) / h[i]
                        - (e[i] - e[i - 1]) / h[i - 1])
    c = np.linalg.solve(a_mat, rhs)
    b = np.diff(e) / h - h * (2.0 * c[:-1] + c[1:]) / 3.0
    d = np.diff(c) / (3.0 * h)
    maxima = []
    for i in range(n - 1):
        roots = np.roots([3.0 * d[i], 2.0 * c[i], b[i]]) if abs(d[i]) > 1e-30 \
            else (np.array([-b[i] / (2.0 * c[i])]) if abs(c[i]) > 1e-30
                  else np.array([]))
        for r in np.real(roots[np.abs(np.imag(roots)) < 1e-12]):
            if 0.0 < r < h[i] and (2.0 * c[i] + 6.0 * d[i] * r) < 0.0:
                maxima.append(s[i] + r)
    new_p = path.detach().clone()
    for dist in maxima:
        for i in range(2, n - 2):
            if s[i] >= dist or dist >= s[i + 1]:
                continue
            t = (dist - s[i]) / (s[i + 1] - s[i])
            interp = path[i] + (path[i + 1] - path[i]) * t
            new_p[i] = _idpp_refine_middle(path[i], interp, path[i + 1])
    return new_p


def per_image_trust_clamp(path, forces, mv, end_tr=0.5):
    """Per-image trust-radius clamp: an interior image's move is limited to
    half its distance to a neighbour it moves toward, and a move against
    the image's NEB force is zeroed (projected velocity Verlet); endpoints
    get min(end_tr, |d|)."""
    eps = 1e-15
    x_prev = torch.roll(path, 1, 0)
    x_next = torch.roll(path, -1, 0)
    d_norm = torch.sqrt(_image_dot(mv, mv) + eps)
    tr1 = 0.5 * torch.sqrt(_image_dot(path - x_prev, path - x_prev) + eps)
    tr2 = 0.5 * torch.sqrt(_image_dot(x_next - path, x_next - path) + eps)
    u1 = (x_prev - path) / (2.0 * tr1 + eps)
    u2 = (x_next - path) / (2.0 * tr2 + eps)
    dhat = mv / d_norm
    cos1 = _image_dot(u1, dhat)
    cos2 = _image_dot(u2, dhat)
    f_norm = torch.sqrt(_image_dot(forces, forces) + eps)
    fcos = _image_dot(forces, mv) / (f_norm * d_norm)
    clamp1 = tr1 / d_norm
    clamp2 = tr2 / d_norm
    xor_case = (cos1 > 0) ^ (cos2 > 0)
    both_neg = (cos1 < 0) & (cos2 < 0)
    scale_xor = torch.where((d_norm > tr1) & (cos1 > 0), clamp1,
                            torch.where((d_norm > tr2) & (cos2 > 0), clamp2,
                                        1.0))
    scale_else = torch.where(d_norm > tr1, clamp1,
                             torch.where(d_norm > tr2, clamp2, 1.0))
    scale = torch.where(both_neg, 1.0,
                        torch.where(xor_case, scale_xor, scale_else))
    scale = torch.where(fcos >= 0, scale, 0.0)
    idx = torch.arange(path.shape[0], device=path.device)
    is_end = ((idx == 0) | (idx == path.shape[0] - 1))[:, None, None]
    end_scale = torch.clamp(end_tr / d_norm, max=1.0)
    return mv * torch.where(is_end, end_scale, scale)


# --------------------------------------------------------------------------
# band clocks
# --------------------------------------------------------------------------

class AFireState(NamedTuple):
    """Per-image FIRE clocks."""
    velocity: torch.Tensor   # (I,N,3)
    dt: torch.Tensor         # (I,)
    alpha: torch.Tensor      # (I,)
    n_good: torch.Tensor     # (I,) int32


def afire_init(n_images, n_atoms, dtype=torch.float64, dt0=0.1, alpha0=0.1,
               device=None):
    return AFireState(
        velocity=torch.zeros((n_images, n_atoms, 3), dtype=dtype,
                             device=device),
        dt=torch.full((n_images,), dt0, dtype=dtype, device=device),
        alpha=torch.full((n_images,), alpha0, dtype=dtype, device=device),
        n_good=torch.zeros((n_images,), dtype=torch.int32, device=device))


def afire_step(state, forces, dt_max=1.0, n_acc=5, f_inc=1.10, f_acc=0.99,
               f_dec=0.50, alpha_start=0.1, maxstep=0.1):
    """One adaptive-FIRE step with independent per-image dt, alpha and
    n_good; each image's move is clamped to `maxstep`."""
    v = state.velocity
    power = (v * forces).sum((1, 2))
    vnorm = torch.sqrt((v * v).sum((1, 2)) + 1e-30)
    fnorm = torch.sqrt((forces * forces).sum((1, 2)) + 1e-30)
    downhill = power > 0.0
    accelerate = downhill & (state.n_good > n_acc)
    dt = torch.where(downhill,
                     torch.where(accelerate,
                                 torch.clamp(state.dt * f_inc, max=dt_max),
                                 state.dt),
                     state.dt * f_dec)
    alpha = torch.where(downhill,
                        torch.where(accelerate, state.alpha * f_acc,
                                    state.alpha),
                        torch.full_like(state.alpha, alpha_start))
    a3 = state.alpha[:, None, None]
    v_mix = (1.0 - a3) * v + a3 * (vnorm / fnorm)[:, None, None] * forces
    v_new = torch.where(downhill[:, None, None], v_mix, 0.0) \
        + dt[:, None, None] * forces
    n_good = torch.where(downhill, state.n_good + 1, 0).to(torch.int32)
    mv = dt[:, None, None] * v_new
    mv_norm = torch.sqrt(_image_dot(mv, mv) + 1e-30)
    mv = mv * torch.clamp(maxstep / mv_norm, max=1.0)
    return mv, AFireState(v_new, dt, alpha, n_good)


@dataclasses.dataclass(frozen=True)
class NEBConfig:
    """The reference's fields and defaults. `optimizer` is one of
    `OPTIMIZERS`; `redistribute` one of
    `interpolation.REDISTRIBUTION_SCHEMES` (or "" for none)."""

    variant: str = "cineb"
    optimizer: str = "fire"
    rfo_ratio: float = 0.5        # RFO fraction of the interior move
    n_steps: int = 100
    k_spring: float = 0.01
    climbing_start: int = 10
    optimize_endpoints: bool = False
    fmax: float = 4.5e-4          # max |force| component convergence
    dt0: float = 0.3
    dt_max: float = 1.0
    sd_step: float = 0.5          # sd/quickmin/lbfgs/cg step scale
    max_move: float = 0.3         # per-image move clamp (Bohr)
    per_image_trust: bool = False
    dmf_beta: float = 10.0
    dmf_nsegs: int = 4
    # in-loop image redistribution every `redistribute_every` iterations
    redistribute: str = ""
    redistribute_every: int = 0
    savgol_window: int = 5
    savgol_order: int = 3
    # '-ci [start interval]': spline-located maximum insertion
    spline_ci_start: int = 0
    spline_ci_interval: int = 0
    scan_chunk: int = 0           # >1: the chunked driver's order (neb())


class NEBResult(NamedTuple):
    path: torch.Tensor          # (I,N,3)
    energies: torch.Tensor      # (I,)
    converged: bool
    n_iterations: int
    energy_history: np.ndarray
    ts_index: int               # highest-energy interior image


class RFONEBState(NamedTuple):
    """Carry of the blended FIRE + per-image RS-RFO band clock."""
    fire: tuple                 # FireState of the band
    hessians: torch.Tensor      # (I,D,D) per-image quasi-Newton Hessians
    prev_x: torch.Tensor        # (I,D)
    prev_g: torch.Tensor        # (I,D) raw per-image gradients
    have_prev: torch.Tensor     # bool scalar


def rfo_neb_init(path0, dtype=None, dt0=0.3):
    dt = dtype or path0.dtype
    n_img = path0.shape[0]
    d = path0.shape[1] * 3
    dev = path0.device
    return RFONEBState(
        fire=fire_init(path0.numel(), dt, dt0=dt0, device=dev),
        hessians=torch.eye(d, dtype=dt, device=dev).repeat(n_img, 1, 1),
        prev_x=torch.zeros((n_img, d), dtype=dt, device=dev),
        prev_g=torch.zeros((n_img, d), dtype=dt, device=dev),
        have_prev=torch.tensor(False, device=dev))


def _batched(state):
    """A B = 1 engine state from an unbatched one."""
    return type(state)(*(leaf[None] for leaf in state))


def band_clock_init(path, config):
    """The clock state of `config.optimizer` for the band `path`."""
    n_dof = path.numel()
    dev = path.device
    if config.optimizer == "lbfgs":
        return _batched(lbfgs_init(n_dof, dtype=path.dtype, device=dev))
    if config.optimizer.startswith("cg"):
        return _batched(cg_init(n_dof, path.dtype, device=dev))
    if config.optimizer == "afire":
        return afire_init(path.shape[0], path.shape[1], path.dtype,
                          dt0=config.dt0, device=dev)
    if config.optimizer == "rfo":
        return rfo_neb_init(path, dt0=config.dt0)
    return fire_init(n_dof, path.dtype, dt0=config.dt0, device=dev)


def _rfo_move(state, path, forces, grads, config):
    """The blended clock: the band force drives FIRE, the raw per-image
    gradient a per-image RS-RFO (FSB at the endpoints, Bofill inside) whose
    interior solve sees the tangent-projected Hessian plus a stiff tangent
    penalty; interior move (1-r) FIRE + r RFO, endpoints pure RFO."""
    from multioptpy_tpu_torch.hessian.updates import bofill_delta, fsb_delta
    from multioptpy_tpu_torch.steppers.rfo import rs_rfo_step

    n_img = path.shape[0]
    d = path.shape[1] * 3
    dev, dt = path.device, path.dtype
    x_flat = path.reshape(n_img, d)
    g_raw = grads.reshape(n_img, d)
    idx = torch.arange(n_img, device=dev)
    endpoint = (idx == 0) | (idx == n_img - 1)
    s_v = x_flat - state.prev_x
    y_v = g_raw - state.prev_g
    h = state.hessians
    eye = torch.eye(d, dtype=dt, device=dev)
    dh = torch.where(endpoint[:, None, None], fsb_delta(h, s_v, y_v),
                     bofill_delta(h, s_v, y_v))
    # stalled moves (|s| ~ 0) skip the update; a non-finite result resets
    # the image's Hessian to identity
    small = torch.linalg.vector_norm(s_v, dim=-1) < 1e-8
    h2 = h + torch.where(small[:, None, None], 0.0, dh)
    ok = torch.isfinite(h2).all(-1).all(-1)
    h_upd = torch.where(ok[:, None, None], h2, eye)
    h_new = torch.where(state.have_prev, h_upd, h)

    tan = torch.roll(x_flat, -1, 0) - torch.roll(x_flat, 1, 0)
    tan = tan / (torch.linalg.vector_norm(tan, dim=1, keepdim=True) + 1e-30)
    g_perp = g_raw - (g_raw * tan).sum(1, keepdim=True) * tan
    g_eff = torch.where(endpoint[:, None], g_raw, g_perp)
    tt = tan[:, :, None] * tan[:, None, :]
    p = eye - tt
    h_eff = torch.where(endpoint[:, None, None], h_new, p @ h_new @ p + tt)
    tr = torch.where(endpoint, 0.5, torch.tensor(0.2, dtype=dt, device=dev))
    rfo_mv, _ = rs_rfo_step(g_eff, h_eff, tr, saddle_order=0)
    lim = torch.where(endpoint, 0.2, torch.tensor(0.1, dtype=dt, device=dev))
    nrm = torch.linalg.vector_norm(rfo_mv, dim=1, keepdim=True)
    rfo_mv = rfo_mv * torch.clamp(lim[:, None] / torch.clamp(nrm, min=1e-30),
                                  max=1.0)
    mv_f, fire_inner = fire_step(state.fire, -forces.reshape(-1),
                                 dt_max=config.dt_max)
    r = config.rfo_ratio
    mv_all = torch.where(endpoint[:, None], rfo_mv,
                         (1.0 - r) * mv_f.reshape(n_img, d) + r * rfo_mv)
    return mv_all.reshape(-1), RFONEBState(
        fire=fire_inner, hessians=h_new, prev_x=x_flat, prev_g=g_raw,
        have_prev=torch.ones_like(state.have_prev))


def make_neb_step(calc, z, config=NEBConfig(), bias_engine=None):
    """One NEB iteration: (path, clock_state, it) -> (path', clock_state',
    energies, gradients, fmax) with the energies and gradients of the band
    the step started from."""
    opt = config.optimizer
    if opt not in OPTIMIZERS and not opt.startswith("cg"):
        raise ValueError(f"unknown NEB optimizer '{opt}' (choose from "
                         f"{', '.join(OPTIMIZERS)})")
    base_variant = "neb" if config.variant == "cineb" else config.variant

    def step(path, state, iteration):
        energies, grads = hosteval.energy_and_gradient(calc, path, z,
                                                       bias_engine)
        climbing = (config.variant == "cineb"
                    and iteration >= config.climbing_start)
        forces = neb_forces(path, energies, grads, config.k_spring,
                            base_variant, climbing, config.optimize_endpoints,
                            config.dmf_beta, config.dmf_nsegs)
        flat_f = forces.reshape(-1)
        if opt == "afire":
            mv, new = afire_step(state, forces, dt_max=config.dt_max,
                                 maxstep=config.max_move)
            move = mv.reshape(-1)
        elif opt == "fire":
            move, new = fire_step(state, -flat_f, dt_max=config.dt_max)
        elif opt == "quickmin":
            # velocity projected onto the force direction
            f_hat = flat_f / (torch.linalg.vector_norm(flat_f) + 1e-30)
            v_proj = torch.clamp(state.velocity @ f_hat, min=0.0) * f_hat
            v_new = v_proj + state.dt * flat_f
            move = state.dt * v_new
            new = state._replace(velocity=v_new)
        elif opt == "lbfgs":
            move, new = lbfgs_step(state, path.reshape(1, -1), -flat_f[None],
                                   delta=config.sd_step)
            move = move[0]
        elif opt == "rfo":
            move, new = _rfo_move(state, path, forces, grads, config)
        elif opt.startswith("cg"):
            variant = opt.split("_", 1)[1] if "_" in opt else "pr"
            move, new = cg_step(state, -flat_f[None], variant=variant,
                                delta=config.sd_step)
            move = move[0]
        else:  # sd
            move = config.sd_step * flat_f
            new = state
        mv = move.reshape(path.shape)
        if config.per_image_trust:
            mv = per_image_trust_clamp(path, forces, mv)
        else:
            mv_norm = torch.sqrt(_image_dot(mv, mv) + 1e-30)
            mv = mv * torch.clamp(config.max_move / mv_norm, max=1.0)
        path_new = path + mv
        if config.variant in ("qsm", "string"):
            # string-method reparametrization: equal arc-length respacing
            path_new = linear_resample(path_new, path.shape[0])
        return path_new, new, energies, grads, forces.abs().amax()

    return step


def neb_state_from_numpy(path, fire_state, iteration, device=None):
    """(path (I,N,3), FireState, iteration) tensors from the reference's
    band, FIRE state and iteration as numpy, so a band can be resumed in
    both packages. `fire_state` is a FireState or a dict of its fields."""
    dev = resolve_device(device)
    path = np.asarray(path)
    dtype = torch.float64 if path.dtype == np.float64 else torch.float32
    fs = fire_state._asdict() if hasattr(fire_state, "_asdict") \
        else dict(fire_state)
    state = FireState(
        velocity=torch.as_tensor(np.asarray(fs["velocity"]), dtype=dtype,
                                 device=dev),
        dt=torch.as_tensor(np.asarray(fs["dt"]), dtype=dtype, device=dev),
        alpha=torch.as_tensor(np.asarray(fs["alpha"]), dtype=dtype,
                              device=dev),
        n_good=torch.as_tensor(np.asarray(fs["n_good"]), dtype=torch.int32,
                               device=dev))
    return (torch.as_tensor(path, dtype=dtype, device=dev), state,
            int(iteration))


def _result(path, energies, converged, it, e_hist):
    e_np = energies.detach().cpu().numpy()
    ts_index = int(np.argmax(e_np[1:-1])) + 1 if len(e_np) > 2 else 0
    return NEBResult(path=path, energies=energies, converged=converged,
                     n_iterations=it, energy_history=np.asarray(e_hist),
                     ts_index=ts_index)


def _host_work(path, it, config, energies, grads, z):
    """The redistribution and the spline-CI insertion due after iteration
    `it`, in the reference's order."""
    if (config.redistribute and config.redistribute_every
            and it % config.redistribute_every == 0 and it < config.n_steps):
        path = redistribute_path(
            path, config.redistribute, energies=energies, gradients=grads,
            z=np.asarray(z), savgol_window=config.savgol_window,
            savgol_order=config.savgol_order)
    if (config.spline_ci_interval and it > config.spline_ci_start
            and (it - config.spline_ci_start) % config.spline_ci_interval == 0
            and it < config.n_steps):
        path = spline_climbing_insert(path, energies)
    return path


def neb(calc, path0, z, config=NEBConfig(), bias_engine=None, callback=None,
        device=None):
    """Run NEB on an (I,N,3) initial path. `device` (None means the CUDA
    card) must be where `calc` lives. With `config.scan_chunk > 1` (and no
    callback) a step whose fmax falls below `config.fmax` returns its band
    before the host work (redistribution, spline-CI insertion) due at its
    iteration, as the reference's chunked driver does (it does that work
    only between segments, which end on every such iteration); otherwise
    after it, as its per-step loop."""
    dev = calc_device(calc, device, "the band")
    path = on_device(path0, dev)
    state = band_clock_init(path, config)
    step = make_neb_step(calc, z, config, bias_engine)
    chunked = bool(config.scan_chunk and config.scan_chunk > 1
                   and callback is None)
    e_hist = []
    converged = False
    it = 0
    energies = None
    for it in range(1, config.n_steps + 1):
        path_pre = path
        path, state, energies, grads, fmax = step(path, state, it)
        e_hist.append(energies.detach().cpu().numpy())
        converged = float(fmax) < config.fmax
        if converged and chunked:
            break
        path = _host_work(path, it, config, energies, grads, z)
        if callback is not None:
            callback(it, path_pre, energies, grads, fmax)
        if converged:
            break
    return _result(path, energies, converged, it, e_hist)


def neb_scan(calc, path0, z, config=NEBConfig(), bias_engine=None,
             device=None):
    """A fixed `config.n_steps` iterations with no early exit and no host
    work; `converged` reads the last step's fmax."""
    dev = resolve_device(device)
    path = on_device(path0, dev)
    step = make_neb_step(calc, z, config, bias_engine)
    state = band_clock_init(path, config)
    e_hist = []
    for it in range(1, config.n_steps + 1):
        path, state, energies, _, fmax = step(path, state, it)
        e_hist.append(energies)
    return _result(path, energies, float(fmax) < config.fmax, config.n_steps,
                   torch.stack(e_hist).detach().cpu().numpy())


# --------------------------------------------------------------------------
# adaptive bands
# --------------------------------------------------------------------------

def adaptive_neb(calc, path0, z, config=NEBConfig(), bias_engine=None,
                 n_rounds=3, growth=1.5, focus=2.0, device=None):
    """Adaptive NEB: after each round the path is repartitioned with the
    image density concentrated around the barrier (`growth` multiplies the
    image count each round, `focus` sharpens the energy weight). Returns
    the last round's NEBResult."""
    dev = resolve_device(device)
    path = on_device(path0, dev)
    res = None
    for round_idx in range(n_rounds):
        res = neb(calc, path, z, config, bias_engine=bias_engine, device=dev)
        if round_idx == n_rounds - 1:
            break
        e = res.energies.detach().cpu().numpy()
        n_img = int(np.ceil(len(e) * growth))
        flat = res.path.detach().cpu().numpy().reshape(len(e), -1)
        seg = np.linalg.norm(np.diff(flat, axis=0), axis=1)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        s = s / max(s[-1], 1e-30)
        w = (e - e.min()) / max(e.max() - e.min(), 1e-30)
        w = 0.2 + w ** focus
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (w[1:] + w[:-1]) * seg)])
        cdf = cdf / max(cdf[-1], 1e-30)
        s_new = np.interp(np.linspace(0.0, 1.0, n_img), cdf, s)
        dense = linear_resample(res.path, 512)
        s_dense = np.linspace(0.0, 1.0, 512)
        idx = np.clip(np.searchsorted(s_dense, s_new), 0, 511)
        path = dense[torch.as_tensor(idx, device=dev)].clone()
        path[0] = res.path[0]
        path[-1] = res.path[-1]
    return res


def aneb_insert(path, energies, interpolation_num):
    """The reference's ANEB insertion rule (numpy): around each strict
    interior local maximum i, `interpolation_num` points linearly between
    images i-1 and i at fractions (j+1)/(num+1), image i, then the same
    between i and i+1; the image count grows by 2 num per maximum."""
    path = np.asarray(path)
    e = np.asarray(energies)
    n = len(e)
    maxima = {i for i in range(1, n - 1) if e[i - 1] < e[i] > e[i + 1]}
    out = []
    for i in range(n):
        if i in maxima:
            for j in range(interpolation_num):
                alpha = (j + 1) / (interpolation_num + 1)
                out.append(path[i - 1] + alpha * (path[i] - path[i - 1]))
            out.append(path[i])
            for j in range(interpolation_num):
                alpha = (j + 1) / (interpolation_num + 1)
                out.append(path[i] + alpha * (path[i + 1] - path[i]))
        else:
            out.append(path[i])
    return np.asarray(out, dtype=path.dtype)


def aneb(calc, path0, z, config=NEBConfig(), bias_engine=None,
         interpolation_num=1, frequency=5, max_images=64, device=None):
    """Adaptive NEB with the reference's -aneb semantics: every `frequency`
    iterations the band is densified around each energy maximum
    (`aneb_insert`) and the clock restarts; `max_images` bounds the growth.
    The climbing-image schedule stays global across growth events."""
    dev = resolve_device(device)
    path = on_device(path0, dev)
    res = None
    steps_done = 0
    while steps_done < config.n_steps:
        seg = min(frequency, config.n_steps - steps_done)
        seg_cfg = dataclasses.replace(
            config, n_steps=seg,
            climbing_start=max(0, config.climbing_start - steps_done))
        res = neb(calc, path, z, seg_cfg, bias_engine=bias_engine, device=dev)
        steps_done += int(res.n_iterations)
        if res.converged or steps_done >= config.n_steps:
            break
        grown = aneb_insert(res.path.detach().cpu().numpy(),
                            res.energies.detach().cpu().numpy(),
                            interpolation_num)
        if len(grown) == len(res.path) or len(grown) > max_images:
            path = res.path
            continue
        path = torch.as_tensor(grown, device=dev)
    return res
