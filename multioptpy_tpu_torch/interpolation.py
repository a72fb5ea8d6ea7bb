"""Path interpolation and image redistribution for NEB.

Counterpart of the linear part of `multioptpy_tpu/interpolation.py`
(`_arc_lengths`, `linear_resample`, `redistribute_path` for the "linear"
scheme); the spline, Bernstein, geodesic, Savitzky-Golay and energy-weighted
schemes arrive with ROADMAP Queue 1 item 11. A path is an (I, N, 3) tensor;
arc length is the cumulative RMS displacement between frames.
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


def linear_resample(path, n_out):
    """Piecewise-linear resample to n_out equally-spaced-by-arc-length
    images."""
    s = _arc_lengths(path)
    t = torch.as_tensor(np.linspace(0.0, 1.0, n_out), dtype=path.dtype,
                        device=path.device)
    out = _interp(t, s, path.reshape(path.shape[0], -1))
    return out.reshape(n_out, *path.shape[1:])


def redistribute_path(path, scheme, energies=None, gradients=None, z=None,
                      savgol_window=5, savgol_order=3):
    """One in-loop redistribution of an (I,N,3) path, keeping the image
    count."""
    del energies, gradients, z, savgol_window, savgol_order
    if scheme == "linear":
        return linear_resample(path, path.shape[0])
    raise NotImplementedError(
        f"redistribution scheme '{scheme}': this port has 'linear'; the "
        "others arrive with ROADMAP Queue 1 item 11")
