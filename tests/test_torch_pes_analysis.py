"""Port parity: the convergence and curvature analyses of
analysis/pes.py (`koopman_convergence_analysis`, `irc_curvature`) against
the JAX package on seeded series and paths, to 1e-12 relative; the short
series that cannot be delay-embedded gives the empty, converging result
in both."""

import numpy as np
import pytest

from multioptpy_tpu.analysis import pes as ref
from multioptpy_tpu_torch.analysis import pes


def _series(kind):
    rng = np.random.default_rng(11)
    t = np.arange(40)
    if kind == "contracting":
        return -5.0 + 0.3 * 0.8 ** t + 1e-3 * 0.5 ** t * rng.random(40)
    if kind == "oscillating":
        return np.cos(0.7 * t) * 1.02 ** t
    if kind == "vector":
        return rng.standard_normal((12, 3)).cumsum(0)
    return np.array([1.0, 0.5, 0.3, 0.2])


@pytest.mark.parametrize("kind", ["contracting", "oscillating", "vector",
                                  "short"])
def test_koopman_matches_reference(kind):
    s = _series(kind)
    a = ref.koopman_convergence_analysis(s)
    b = pes.koopman_convergence_analysis(s)
    assert b.converging == a.converging
    np.testing.assert_allclose(np.sort_complex(b.eigenvalues),
                               np.sort_complex(a.eigenvalues), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.sort(b.decay_rates),
                               np.sort(a.decay_rates), rtol=1e-12,
                               atol=1e-12)
    assert repr(b) == repr(a)


def test_irc_curvature_matches_reference():
    rng = np.random.default_rng(4)
    path = np.cumsum(rng.standard_normal((9, 4, 3)) * 0.1, axis=0)
    path[5] = path[4]      # a zero-length segment is skipped
    np.testing.assert_allclose(pes.irc_curvature(path),
                               ref.irc_curvature(path), rtol=1e-12, atol=0)
