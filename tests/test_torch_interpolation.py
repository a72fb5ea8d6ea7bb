"""Port parity: every resampler and in-loop redistribution scheme of
multioptpy_tpu_torch.interpolation against the JAX package on a random
band of 9 images x 4 atoms with energies that peak inside (the host-side
schemes run the same numpy/scipy arithmetic: 1e-12 relative; the on-device
ones, linear, Bernstein and geodesic, 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu import interpolation as ref
from multioptpy_tpu_torch import interpolation as port

torch.set_num_threads(1)

_Z = np.array([6, 1, 8, 1])


def _band(seed=0, n_img=9, n_atoms=4):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_atoms, 3)) * 1.5
    t = np.linspace(0.0, 1.0, n_img)[:, None, None]
    path = base[None] + t * rng.standard_normal((n_atoms, 3)) \
        + 0.05 * rng.standard_normal((n_img, n_atoms, 3))
    energies = np.sin(np.pi * t[:, 0, 0]) * 0.02 \
        + 1e-3 * rng.standard_normal(n_img)
    grads = 0.01 * rng.standard_normal((n_img, n_atoms, 3))
    return path, energies, grads


def _close(got, want, rtol):
    want = np.asarray(want)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("n_out", [5, 9, 14])
def test_resamplers_match_reference(n_out):
    path, _, _ = _band(1)
    p = torch.as_tensor(path)
    _close(port.cubic_spline_resample(p, n_out),
           ref.cubic_spline_resample(jnp.asarray(path), n_out), 1e-12)
    _close(port.bernstein_resample(p, n_out),
           ref.bernstein_resample(jnp.asarray(path), n_out), 1e-12)
    _close(port.linear_resample(p, n_out),
           ref.linear_resample(jnp.asarray(path), n_out), 1e-12)


def test_savgol_and_geodesic_match_reference():
    path, _, _ = _band(2)
    p = torch.as_tensor(path)
    for window, order in ((5, 2), (7, 3), (11, 2)):   # 11 > 9 images: as is
        _close(port.savitzky_golay_smooth(p, window, order),
               ref.savitzky_golay_smooth(jnp.asarray(path), window, order),
               1e-12)
    for z in (None, _Z):
        _close(port.geodesic_resample(p, 7, z=z, n_iter=25),
               ref.geodesic_resample(jnp.asarray(path), 7, z=z, n_iter=25),
               1e-10)


@pytest.mark.parametrize("scheme", port.REDISTRIBUTION_SCHEMES)
def test_redistribution_schemes_match_reference(scheme):
    path, e, g = _band(3)
    got = port.redistribute_path(torch.as_tensor(path), scheme,
                                 energies=torch.as_tensor(e),
                                 gradients=torch.as_tensor(g), z=_Z,
                                 savgol_window=5, savgol_order=3)
    want = ref.redistribute_path(jnp.asarray(path), scheme, energies=e,
                                 gradients=g, z=_Z, savgol_window=5,
                                 savgol_order=3)
    assert got.shape == path.shape and got.dtype == torch.float64
    _close(got, want, 1e-10)


def test_energy_weighted_schemes_with_other_counts_match_reference():
    path, e, g = _band(4)
    p = torch.as_tensor(path)
    for n_out in (6, 12):
        _close(port.ritz_resample(p, e, n_out=n_out, gradients=g),
               ref.ritz_resample(jnp.asarray(path), e, n_out=n_out,
                                 gradients=g), 1e-12)
        _close(port.bernstein_energy_resample(p, e, n_out=n_out),
               ref.bernstein_energy_resample(jnp.asarray(path), e,
                                             n_out=n_out), 1e-12)
        _close(port.adaptive_resample(p, e, g, n_out=n_out),
               ref.adaptive_resample(jnp.asarray(path), e, g, n_out=n_out),
               1e-12)
    # a flat profile and a 3-image path take the reference's early returns
    flat = np.zeros(len(e))
    _close(port.bernstein_energy_resample(p, flat),
           ref.bernstein_energy_resample(jnp.asarray(path), flat), 1e-12)
    _close(port.ritz_resample(p[:3], e[:3]),
           ref.ritz_resample(jnp.asarray(path[:3]), e[:3]), 0)


def test_unknown_scheme_raises():
    path, _, _ = _band(5)
    with pytest.raises(ValueError, match="unknown redistribution scheme"):
        port.redistribute_path(torch.as_tensor(path), "cubic")
