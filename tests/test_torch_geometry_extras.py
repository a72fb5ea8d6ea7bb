"""Port parity: the geometry helpers of multioptpy_tpu_torch.geometry
(distances, safe norm, mass weighting, Kabsch rotation and alignment,
RMSD, bond connectivity), the D2/D4 dispersion gradients and the CMDS/PCA
path embeddings against the JAX package, f64 at 1e-10 relative. The Kabsch
rotation is held on a mirror image too: the reference's determinant-sign
correction keeps det R = +1, and the port's must pick the same rotation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu import geometry as ref_geom
from multioptpy_tpu.analysis import pes as ref_pes
from multioptpy_tpu.hessian import dispersion as ref_disp
from multioptpy_tpu.io.fixtures import diels_alder_reactant
from multioptpy_tpu_torch import geometry
from multioptpy_tpu_torch.analysis import pes
from multioptpy_tpu_torch.hessian import dispersion

torch.set_num_threads(1)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-300)


def _pair(seed=0):
    coords, z = diels_alder_reactant()
    rng = np.random.default_rng(seed)
    angle = 0.9
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    q = (coords @ rot.T + np.array([0.3, -1.2, 2.0])
         + 0.05 * rng.standard_normal(coords.shape))
    return coords, q, z


def test_distances_norm_and_mass_weighting_match_reference():
    p, _, z = _pair()
    masses = geometry.masses_from_z(z)
    got = geometry.pairwise_distances(torch.as_tensor(p)).numpy()
    assert _rel(got, ref_geom.pairwise_distances(jnp.asarray(p))) < 1e-12
    assert np.all(np.diag(got) == 0.0)
    v = torch.as_tensor(p)
    assert _rel(geometry.safe_norm(v).numpy(),
                ref_geom.safe_norm(jnp.asarray(p))) < 1e-14
    assert _rel(geometry.mass_weight_coords(v, masses).numpy(),
                ref_geom.mass_weight_coords(jnp.asarray(p),
                                            jnp.asarray(masses.numpy()))
                ) < 1e-12
    for scale in (1.2, 1.5):
        np.testing.assert_array_equal(
            geometry.bond_connectivity(v, z, scale).numpy(),
            np.asarray(ref_geom.bond_connectivity(jnp.asarray(p),
                                                  jnp.asarray(z), scale)))
    # a batch of structures gives each member's matrix
    batch = torch.stack([v, v + 0.1])
    assert geometry.pairwise_distances(batch).shape == (2, 18, 18)


@pytest.mark.parametrize("mirror", [False, True], ids=["rotated", "mirror"])
def test_kabsch_align_and_rmsd_match_reference(mirror):
    p, q, z = _pair(1)
    if mirror:
        q = q * np.array([1.0, 1.0, -1.0])
    w = geometry.masses_from_z(z).numpy()
    for weights in (None, w):
        tw = None if weights is None else torch.as_tensor(weights)
        jw = None if weights is None else jnp.asarray(weights)
        r = geometry.kabsch_rotation(torch.as_tensor(p), torch.as_tensor(q),
                                     tw).numpy()
        r_ref = np.asarray(ref_geom.kabsch_rotation(jnp.asarray(p),
                                                    jnp.asarray(q), jw))
        assert _rel(r, r_ref) < 1e-10
        assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-12)
        aligned = geometry.align_to(torch.as_tensor(p), torch.as_tensor(q),
                                    tw).numpy()
        assert _rel(aligned, ref_geom.align_to(jnp.asarray(p),
                                               jnp.asarray(q), jw)) < 1e-10
        for align in (True, False):
            got = float(geometry.rmsd(torch.as_tensor(p), torch.as_tensor(q),
                                      tw, align))
            want = float(ref_geom.rmsd(jnp.asarray(p), jnp.asarray(q), jw,
                                       align))
            assert got == pytest.approx(want, rel=1e-10)
    if mirror:
        # a proper rotation cannot undo the reflection
        assert float(geometry.rmsd(torch.as_tensor(p),
                                   torch.as_tensor(q))) > 0.5


def test_d2_and_d4_gradients_match_reference():
    p, q, z = _pair(2)
    x = torch.as_tensor(np.stack([p, q]))
    g2 = dispersion.d2_gradient(x, z).numpy()
    g4 = dispersion.d4_gradient(x, z).numpy()
    for k, c in enumerate((p, q)):
        assert _rel(g2[k], ref_disp.d2_gradient(jnp.asarray(c),
                                                jnp.asarray(z))) < 1e-10
        # ROADMAP F5: the D4 pair tables damp every pair to a near-constant
        # energy, so the gradient is ~1e-17 Ha/Bohr, at the rounding floor
        # of the 1e-5 Ha energy terms: held to 1e-24 absolute (as the D4
        # Hessian is in test_torch_model_hessian.py)
        want = np.asarray(ref_disp.d4_gradient(jnp.asarray(c),
                                               jnp.asarray(z)))
        assert 0.0 < np.abs(want).max() < 1e-15
        np.testing.assert_allclose(g4[k], want, rtol=0, atol=1e-24)


def test_path_embeddings_match_reference_up_to_sign():
    """The eigenvectors' and singular vectors' signs are each library's
    own: each embedding column is compared up to its sign."""
    rng = np.random.default_rng(3)
    traj = np.cumsum(0.1 * rng.standard_normal((12, 5, 3)), axis=0)
    for fn, ref_fn in ((pes.cmds_path_analysis, ref_pes.cmds_path_analysis),
                       (pes.pca_path_analysis, ref_pes.pca_path_analysis)):
        got, want = fn(traj), ref_fn(traj)
        assert got.coords_2d.shape == (12, 2)
        np.testing.assert_allclose(got.explained, want.explained,
                                   rtol=1e-10)
        for col in range(2):
            a, b = got.coords_2d[:, col], np.asarray(want.coords_2d)[:, col]
            sign = 1.0 if np.dot(a, b) >= 0 else -1.0
            np.testing.assert_allclose(sign * a, b, rtol=0, atol=1e-10)
