"""Port parity: geometry constraints against
multioptpy_tpu/constraints/project.py.

One constraint set of every kind (bond, angle, dihedral, fragment
distance, frozen atom, frozen coordinate, fixed projection vector, atom
pair, a resolved Hessian eigenvector) on a batch of two 6-atom geometries:
values, targets, Jacobians, the projected gradient and Hessian and the
mask agree with the reference per row to 1e-10 relative (f64). SHAKE is
30 fixed Gauss-Newton iterations in both: the restored geometries agree to
1e-9 Bohr, and meet their targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.constraints import Constraints as RefConstraints
from multioptpy_tpu_torch.constraints import Constraints

torch.set_num_threads(1)

_X = np.array([[0.0, 0.0, 0.0], [2.9, 0.1, 0.0], [3.8, 2.6, 0.3],
               [6.1, 3.0, 1.9], [-1.2, -2.3, 0.8], [1.0, 4.1, -2.2]])


def _coords(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return _X[None] + 0.15 * rng.standard_normal((b, 6, 3))


_SPEC = dict(bonds=[(1, 2, None), (3, 4, 1.45)],
             angles=[(1, 2, 3, None)],
             dihedrals=[(1, 2, 3, 4, 150.0)],
             fbonds=[([1, 2], [5, 6], None)],
             fixed_atoms=[6], fixed_coords=[(5, "z")],
             projection_vectors=[np.linspace(-1.0, 1.0, 18)],
             atoms_pairs=[(2, 5)])


def _both(spec=_SPEC):
    return (Constraints(n_atoms=6, **spec), RefConstraints(n_atoms=6, **spec))


def _close(got, want, what, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def test_values_targets_and_jacobian_match_reference():
    got, want = _both()
    x = _coords()
    t = got.targets(torch.as_tensor(x))
    vals = got.values(torch.as_tensor(x))
    jac = got.jacobian(torch.as_tensor(x))
    assert got.n_constraints == want.n_constraints == 5
    assert got.has_any() and want.has_any()
    for i in range(2):
        xi = jnp.asarray(x[i])
        _close(vals[i].numpy(), want.values(xi), f"values {i}")
        _close(t[i].numpy(), want.targets(x[i]), f"targets {i}")
        _close(jac[i].numpy(), want.jacobian(xi), f"jacobian {i}")
    _close(got.mask().numpy(), want.mask(), "mask")


def test_projections_match_reference():
    got, want = _both()
    x = _coords(1)
    rng = np.random.default_rng(2)
    g = rng.standard_normal((2, 6, 3))
    a = rng.standard_normal((2, 18, 18))
    h = a + a.transpose(0, 2, 1)
    pg = got.project_gradient(torch.as_tensor(g), torch.as_tensor(x))
    ph = got.project_hessian(torch.as_tensor(h), torch.as_tensor(x))
    for i in range(2):
        xi = jnp.asarray(x[i])
        _close(pg[i].numpy(), want.project_gradient(jnp.asarray(g[i]), xi),
               f"gradient {i}")
        _close(ph[i].numpy(), want.project_hessian(jnp.asarray(h[i]), xi),
               f"hessian {i}")
    # with primitives alone, the projected gradient has no component along
    # a constraint normal
    only = Constraints(n_atoms=6, bonds=_SPEC["bonds"],
                       dihedrals=_SPEC["dihedrals"])
    pg = only.project_gradient(torch.as_tensor(g), torch.as_tensor(x))
    jac = only.jacobian(torch.as_tensor(x))
    assert (jac @ pg.reshape(2, -1, 1)).abs().max() < 1e-10


def test_shake_matches_reference_and_meets_the_targets():
    spec = dict(_SPEC, projection_vectors=[], atoms_pairs=[])
    got, want = _both(spec)
    x0 = _coords(3)
    targets = got.targets(torch.as_tensor(x0))
    moved = x0 + 0.2 * np.random.default_rng(4).standard_normal(x0.shape)
    shaken = got.shake(torch.as_tensor(moved), targets)
    for i in range(2):
        ref_t = want.targets(x0[i])
        _close(shaken[i].numpy(), want.shake(jnp.asarray(moved[i]), ref_t),
               f"row {i}", rtol=0, atol=1e-9)
    left = got.values(shaken) - targets
    left[:, 3] = torch.atan2(torch.sin(left[:, 3]), torch.cos(left[:, 3]))
    assert left.abs().max() < 1e-8
    np.testing.assert_array_equal(shaken[:, 5].numpy(), moved[:, 5])
    np.testing.assert_array_equal(shaken[:, 4, 2].numpy(), moved[:, 4, 2])


@pytest.mark.parametrize("modes", [[0], [0, 2]])
def test_resolve_eigvecs_matches_reference(modes):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((18, 18))
    h = a + a.T
    got = Constraints(eigvec_modes=modes, n_atoms=6)
    want = RefConstraints(eigvec_modes=modes, n_atoms=6)
    got.resolve_eigvecs(torch.as_tensor(h))
    want.resolve_eigvecs(jnp.asarray(h))
    assert not got.eigvec_modes and not want.eigvec_modes
    for u, v in zip(got.projection_vectors, want.projection_vectors):
        _close(u * np.sign(u @ v), v, "eigenvector")
    g = rng.standard_normal((1, 6, 3))
    x = _coords(6, b=1)
    _close(got.project_gradient(torch.as_tensor(g),
                                torch.as_tensor(x))[0].numpy(),
           want.project_gradient(jnp.asarray(g[0]), jnp.asarray(x[0])),
           "projected gradient")


def test_empty_set_is_a_no_op():
    got = Constraints(n_atoms=6)
    assert got.n_constraints == 0 and not got.has_any()
    x = torch.as_tensor(_coords())
    assert got.shake(x, got.targets(x)) is x
    assert got.values(x).shape == (2, 0)
