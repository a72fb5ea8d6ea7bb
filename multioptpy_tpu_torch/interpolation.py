"""Path interpolation and image redistribution for NEB.

Counterpart of `multioptpy_tpu/interpolation.py`: linear, natural cubic
spline, Bernstein, Savitzky-Golay and geodesic resampling, the energy-
weighted Bernstein, Ritz and hidden-TS adaptive redistributions, and the
`redistribute_path` dispatcher over `REDISTRIBUTION_SCHEMES`. A path is an
(I, N, 3) tensor; arc length is the cumulative RMS displacement between
frames. The schemes the reference computes on the host in numpy (spline,
Savitzky-Golay, the energy-weighted ones) do so here too and return a
tensor on the path's device.
"""

import numpy as np
import torch


def _arc_lengths(path):
    """(I,N,3) -> (I,) normalized cumulative arc length in [0, 1]."""
    seg = torch.sqrt(((path[1:] - path[:-1]) ** 2).sum((1, 2)) + 1e-30)
    s = torch.cat([path.new_zeros(1), torch.cumsum(seg, 0)])
    return s / s[-1]


def _interp(x, xp, fp):
    """`numpy.interp` of every column of fp (K, D) at x (J,), in the
    reference's arithmetic (jax.numpy.interp)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = (xp[i] - xp[i - 1])[:, None]
    delta = (x - xp[i - 1])[:, None]
    eps = np.spacing(torch.finfo(xp.dtype).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where((x < xp[0])[:, None], fp[0], f)
    return torch.where((x > xp[-1])[:, None], fp[-1], f)


def _like(arr, path):
    """numpy array -> tensor with the path's dtype and device."""
    return torch.as_tensor(np.asarray(arr), dtype=path.dtype,
                           device=path.device)


def _np(path):
    return (path.detach().cpu().numpy() if isinstance(path, torch.Tensor)
            else np.asarray(path))


def _linspace(n, path):
    return torch.as_tensor(np.linspace(0.0, 1.0, n), dtype=path.dtype,
                           device=path.device)


def linear_resample(path, n_out):
    """Piecewise-linear resample to n_out equally-spaced-by-arc-length
    images."""
    s = _arc_lengths(path)
    out = _interp(_linspace(n_out, path), s,
                  path.reshape(path.shape[0], -1))
    return out.reshape(n_out, *path.shape[1:])


def cubic_spline_resample(path, n_out):
    """Natural cubic spline through the images, resampled uniformly in arc
    length: the tridiagonal second-derivative system per coordinate, solved
    on the host."""
    s = _np(_arc_lengths(path))
    y = _np(path).reshape(path.shape[0], -1)
    n = len(s)
    h = np.diff(s)
    a = np.zeros((n, n))
    b = np.zeros((n, y.shape[1]))
    a[0, 0] = a[-1, -1] = 1.0
    for i in range(1, n - 1):
        a[i, i - 1] = h[i - 1]
        a[i, i] = 2.0 * (h[i - 1] + h[i])
        a[i, i + 1] = h[i]
        b[i] = 6.0 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    m = np.linalg.solve(a, b)
    t = np.linspace(0.0, 1.0, n_out)
    idx = np.clip(np.searchsorted(s, t) - 1, 0, n - 2)
    dtc = (t - s[idx])[:, None]
    hi = h[idx][:, None]
    yi, yi1 = y[idx], y[idx + 1]
    mi, mi1 = m[idx], m[idx + 1]
    out = (mi * (hi - dtc) ** 3 + mi1 * dtc ** 3) / (6.0 * hi) \
        + (yi / hi - mi * hi / 6.0) * (hi - dtc) \
        + (yi1 / hi - mi1 * hi / 6.0) * dtc
    return _like(out.reshape(n_out, *path.shape[1:]), path)


def bernstein_resample(path, n_out):
    """Bezier/Bernstein-polynomial smoothing through the control images,
    endpoints pinned."""
    i = path.shape[0]
    t = _linspace(n_out, path)[:, None]
    k = torch.arange(i, dtype=path.dtype, device=path.device)[None, :]
    log_binom = (torch.lgamma(torch.tensor(float(i), dtype=path.dtype,
                                           device=path.device))
                 - torch.lgamma(k + 1.0) - torch.lgamma(i - k))
    eps = 1e-12
    log_b = log_binom + k * torch.log(t + eps) \
        + (i - 1 - k) * torch.log(1 - t + eps)
    w = torch.exp(log_b)
    w = w / w.sum(1, keepdim=True)
    flat = path.reshape(i, -1)
    out = w @ flat
    out = torch.cat([flat[:1], out[1:-1], flat[-1:]])
    return out.reshape(n_out, *path.shape[1:])


def savitzky_golay_smooth(path, window=5, order=2):
    """Polynomial smoothing of the path (scipy, on the host), endpoints
    fixed."""
    from scipy.signal import savgol_filter

    p = _np(path)
    if p.shape[0] < window:
        return _like(p, path)
    sm = savgol_filter(p, window, order, axis=0)
    sm[0], sm[-1] = p[0], p[-1]
    return _like(sm, path)


def geodesic_resample(path, n_out, z=None, n_iter=60, alpha=1.7):
    """Geodesic-flavoured redistribution (Zhu et al., JCTC 15 (2019) 5787):
    resample, then relax the interior images to minimize the sum of squared
    Morse-scaled internal-coordinate jumps between neighbours, with the
    reference's damped dynamics (n_iter steps, adaptive dt)."""
    from multioptpy_tpu_torch.periodic import COVALENT_RADII_1

    path0 = linear_resample(path, n_out)
    n_atoms = path0.shape[1]
    if z is not None:
        radii = np.asarray(COVALENT_RADII_1)[np.asarray(z)]
        r0 = radii[:, None] + radii[None, :]
    else:
        r0 = np.full((n_atoms, n_atoms), 3.0)
    iu, ju = np.triu_indices(n_atoms, 1)
    iu = torch.as_tensor(iu, device=path.device)
    ju = torch.as_tensor(ju, device=path.device)
    r0 = _like(r0, path)[iu, ju]

    def objective(interior):
        full = torch.cat([path0[:1], interior, path0[-1:]])
        d = full[:, iu] - full[:, ju]
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        qs = torch.exp(-alpha * (r / r0 - 1.0)) + 0.1 * r0 / r
        return ((qs[1:] - qs[:-1]) ** 2).sum()

    x = path0[1:-1].detach()
    v = torch.zeros_like(x)
    dt = torch.tensor(0.02, dtype=path.dtype, device=path.device)
    for _ in range(n_iter):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(xx), xx)
        power = (-g * v).sum()
        v = torch.where(power > 0, 0.9 * v - dt * g, -dt * g)
        dt = torch.where(power > 0, torch.clamp(dt * 1.05, max=0.2), dt * 0.5)
        x = x + dt * v
    return torch.cat([path0[:1], x, path0[-1:]])


RESAMPLERS = {
    "linear": linear_resample,
    "spline": cubic_spline_resample,
    "bernstein": bernstein_resample,
    "geodesic": geodesic_resample,
}


def _inverse_cdf(w, grid, n_out):
    """Positions on `grid` that split the trapezoid integral of w into
    n_out - 1 equal parts."""
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (w[1:] + w[:-1])
                                           * np.diff(grid))])
    cdf /= cdf[-1]
    return np.interp(np.linspace(0.0, 1.0, n_out), cdf, grid)


def bernstein_energy_resample(path, energies, n_out=None, concentration=2.0):
    """Energy-weighted Bernstein redistribution: Bezier-smooth the path and
    place the images by inverse-CDF sampling of an energy-concentrated
    density, so images crowd the barrier. Host-side."""
    from scipy.special import gammaln

    path_np = _np(path)
    energies = _np(energies)
    n_old = len(path_np)
    n_out = n_old if n_out is None else int(n_out)
    flat = path_np.reshape(n_old, -1)
    seg = np.linalg.norm(np.diff(flat, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    if s[-1] < 1e-12:
        return _like(path_np, path)
    s /= s[-1]
    e_rng = energies.max() - energies.min()
    if e_rng > 1e-12:
        e_sc = np.interp(np.linspace(0, 1, 400), s,
                         (energies - energies.min()) / e_rng)
        w = 1.0 + concentration * (np.exp(2.0 * e_sc) - 1.0)
    else:
        w = np.ones(400)
    t_new = _inverse_cdf(w, np.linspace(0.0, 1.0, 400), n_out)
    k = np.arange(n_old)
    log_binom = gammaln(n_old) - gammaln(k + 1.0) - gammaln(n_old - k)
    eps = 1e-12
    log_b = (log_binom[None, :] + k[None, :] * np.log(t_new[:, None] + eps)
             + (n_old - 1 - k)[None, :] * np.log(1 - t_new[:, None] + eps))
    wgt = np.exp(log_b)
    wgt /= wgt.sum(axis=1, keepdims=True)
    out = (wgt @ flat).reshape(n_out, *path_np.shape[1:])
    out[0], out[-1] = path_np[0], path_np[-1]
    return _like(out, path)


#: the in-loop redistribution schemes (each keeps the image count) and the
#: nebmain flag that selects each
REDISTRIBUTION_SCHEMES = (
    "linear",            # -ad    equal arc-length intervals
    "energy",            # -adene energy-weighted intervals
    "pred",              # -adpred cubic predicted (gradient-corrected)
    "ritz",              # -adrpred B-spline Ritz (gradient-corrected)
    "spline",            # -ads   cubic-spline equal intervals
    "spline2",           # -ads2  spline ver.2
    "geodesic",          # -adg   geodesic (morse-scaled internals)
    "bernstein",         # -adb   Bernstein smoothing
    "bernstein_energy",  # -adbene energy-weighted Bernstein
    "adaptive",          # -adadene adaptive geometry+energy (hidden TS)
    "savgol",            # -adsg  Savitzky-Golay smoothing
)


def redistribute_path(path, scheme, energies=None, gradients=None, z=None,
                      savgol_window=5, savgol_order=3):
    """One in-loop redistribution of an (I,N,3) path, keeping the image
    count."""
    n = path.shape[0]
    if scheme == "linear":
        return linear_resample(path, n)
    if scheme in ("spline", "spline2"):
        return cubic_spline_resample(path, n)
    if scheme == "bernstein":
        return bernstein_resample(path, n)
    if scheme == "geodesic":
        return geodesic_resample(path, n, z=z, n_iter=30)
    if scheme == "savgol":
        return savitzky_golay_smooth(path, window=savgol_window,
                                     order=savgol_order)
    if scheme == "energy":
        return ritz_resample(path, energies, n_out=n, gradients=None)
    if scheme in ("pred", "ritz"):
        return ritz_resample(path, energies, n_out=n, gradients=gradients)
    if scheme == "bernstein_energy":
        return bernstein_energy_resample(path, energies, n_out=n)
    if scheme == "adaptive":
        return adaptive_resample(path, energies, gradients, n_out=n)
    raise ValueError(f"unknown redistribution scheme '{scheme}' "
                     f"(choose from {REDISTRIBUTION_SCHEMES})")


def ritz_resample(path, energies, n_out=None, gradients=None,
                  concentration=2.0):
    """B-spline Ritz redistribution: cubic-spline the geometry and the
    energy (Hermite with the path-projected gradient when `gradients` are
    given) along normalized arc length, then place the images by inverse-
    CDF sampling of w(s) = 1 + c (exp(2 E_scaled(s)) - 1). Host-side."""
    from scipy.interpolate import CubicHermiteSpline, CubicSpline

    path_np = _np(path)
    energies = _np(energies)
    n_old = len(path_np)
    n_out = n_old if n_out is None else int(n_out)
    flat = path_np.reshape(n_old, -1)
    seg = np.linalg.norm(np.diff(flat, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    if s[-1] < 1e-12 or n_old < 4:
        return _like(path_np, path)
    s = s / s[-1]
    geom_sp = CubicSpline(s, flat, axis=0)
    if gradients is not None:
        g = _np(gradients).reshape(n_old, -1)
        tan = np.gradient(flat, s, axis=0)
        tn = np.linalg.norm(tan, axis=1, keepdims=True)
        tn[tn < 1e-12] = 1.0
        de_ds = np.sum(g * tan / tn, axis=1) * np.sum(seg)
        e_sp = CubicHermiteSpline(s, energies, de_ds)
    else:
        e_sp = CubicSpline(s, energies)
    s_fine = np.linspace(0.0, 1.0, 1000)
    e_fine = e_sp(s_fine)
    e_rng = e_fine.max() - e_fine.min()
    if concentration > 1e-3 and e_rng > 1e-12:
        e_sc = (e_fine - e_fine.min()) / e_rng
        w = 1.0 + concentration * (np.exp(2.0 * e_sc) - 1.0)
    else:
        w = np.ones_like(s_fine)
    s_new = _inverse_cdf(w, s_fine, n_out)
    out = geom_sp(s_new).reshape(n_out, *path_np.shape[1:])
    out[0], out[-1] = path_np[0], path_np[-1]
    return _like(out, path)


def adaptive_resample(path, energies, gradients, n_out=None,
                      boost_factor=2.0):
    """Hidden-TS adaptive redistribution: a cubic Hermite E(t) on each
    segment from its end energies and path-projected gradients; a segment
    whose cubic has an interior local maximum gets its image-density weight
    raised by `boost_factor`; images by inverse CDF over the weighted
    segment lengths, geometry linear in between. Host-side."""
    path_np = _np(path)
    energies = _np(energies)
    gradients = _np(gradients).reshape(len(path_np), -1)
    n_old = len(path_np)
    n_out = n_old if n_out is None else int(n_out)
    flat = path_np.reshape(n_old, -1)
    seg_vec = np.diff(flat, axis=0)
    seg_len = np.linalg.norm(seg_vec, axis=1)
    weights = np.ones(n_old - 1)
    for i in range(n_old - 1):
        length = seg_len[i]
        if length < 1e-8:
            continue
        u = seg_vec[i] / length
        e0, e1 = energies[i], energies[i + 1]
        d0 = np.dot(gradients[i], u) * length
        d1 = np.dot(gradients[i + 1], u) * length
        a3 = 2 * (e0 - e1) + d0 + d1
        a2 = -3 * (e0 - e1) - 2 * d0 - d1
        a1 = d0
        disc = a2 ** 2 - 3 * a3 * a1
        if disc <= 0:
            continue
        for root in ((-a2 + np.sqrt(disc)) / (3 * a3 + 1e-30),
                     (-a2 - np.sqrt(disc)) / (3 * a3 + 1e-30)):
            if 0.05 < root < 0.95 and 6 * a3 * root + 2 * a2 < 0:
                weights[i] += boost_factor
                break
    cdf = np.concatenate([[0.0], np.cumsum(weights * seg_len)])
    cdf /= cdf[-1]
    s_cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    s_cum /= s_cum[-1]
    s_new = np.interp(np.linspace(0.0, 1.0, n_out), cdf, s_cum)
    out = np.empty((n_out, flat.shape[1]))
    for d in range(flat.shape[1]):
        out[:, d] = np.interp(s_new, s_cum, flat[:, d])
    out = out.reshape(n_out, *path_np.shape[1:])
    out[0], out[-1] = path_np[0], path_np[-1]
    return _like(out, path)
