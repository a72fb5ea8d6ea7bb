"""Port parity: the step enhancements against
multioptpy_tpu/steppers/enhancements.py.

TRIM, mode following, the Armijo line search, component scaling and
coordinate locking run on a batch in the port and per row in the
reference, f64: steps and eigenvalues agree to 1e-10 relative (followed
modes up to the eigenvector sign, which differs between solvers). The
geodesic correction's back-transform is a fixed 25-iteration Gauss-Newton
loop in both; it agrees to 1e-9 Bohr. `perturb_move` draws its noise from
an explicit torch.Generator (jax.random's stream cannot be reproduced): it
is held to the reference's formula on its own draw."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.coords.internals import InternalCoordinates as RefIC
from multioptpy_tpu.steppers import enhancements as ref
from multioptpy_tpu_torch.coords.internals import InternalCoordinates
from multioptpy_tpu_torch.steppers import enhancements as enh

torch.set_num_threads(1)

_B, _D = 4, 9


def _problem(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((_B, _D, _D))
    h = a + a.transpose(0, 2, 1)
    g = rng.standard_normal((_B, _D))
    # rows 0-1 take the Newton step, rows 2-3 are trust-limited
    trust = np.array([1e3, 50.0, 0.05, 0.3])
    return h, g, trust


def _close(got, want, what, rtol=1e-10, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("saddle_order", [0, 1])
def test_trim_step_matches_reference(saddle_order):
    h, g, trust = _problem(1 + saddle_order)
    got = enh.trim_step(torch.as_tensor(g), torch.as_tensor(h),
                        torch.as_tensor(trust), saddle_order=saddle_order)
    for i in range(_B):
        want = ref.trim_step(jnp.asarray(g[i]), jnp.asarray(h[i]), trust[i],
                             saddle_order=saddle_order)
        _close(got[i].numpy(), want, f"row {i}")
    assert (torch.linalg.vector_norm(got[2:], dim=-1)
            <= torch.as_tensor(trust[2:]) * (1 + 1e-9)).all()


@pytest.mark.parametrize("index", [0, 2])
def test_mode_following_direction_matches_reference(index):
    h, _, _ = _problem(3)
    ref_mode = np.random.default_rng(4).standard_normal((_B, _D))
    for reference in (None, ref_mode):
        kw = {} if reference is None else {
            "reference_mode": torch.as_tensor(reference)}
        mode, eig = enh.mode_following_direction(torch.as_tensor(h),
                                                 index=index, **kw)
        for i in range(_B):
            rkw = {} if reference is None else {
                "reference_mode": jnp.asarray(reference[i])}
            want_mode, want_eig = ref.mode_following_direction(
                jnp.asarray(h[i]), index=index, **rkw)
            want_mode = np.asarray(want_mode)
            got = mode[i].numpy() * np.sign(mode[i].numpy() @ want_mode)
            _close(got, want_mode, f"mode {i}")
            _close(eig[i].numpy(), want_eig, f"eigenvalue {i}")


def test_backtracking_linesearch_matches_reference():
    """A quartic well: rows whose full step overshoots take a shorter
    Armijo trial, one row takes none of them (the smallest trial)."""
    rng = np.random.default_rng(5)
    coords = rng.standard_normal((_B, 3, 3))
    move = rng.standard_normal((_B, 3, 3)) * np.array(
        [0.05, 0.8, 2.0, -0.5])[:, None, None]

    def energy(x, lib):
        return lib.sum(x ** 4, axis=(-2, -1)) - lib.sum(x ** 2,
                                                        axis=(-2, -1))

    grad = 4 * coords ** 3 - 2 * coords
    e0 = energy(coords, np)
    got = enh.backtracking_linesearch(
        lambda x: energy(x, torch), torch.as_tensor(coords),
        torch.as_tensor(move), torch.as_tensor(e0),
        torch.as_tensor(grad.reshape(_B, -1)))
    for i in range(_B):
        want = ref.backtracking_linesearch(
            lambda x: energy(x, jnp), jnp.asarray(coords[i]),
            jnp.asarray(move[i]), e0[i], jnp.asarray(grad[i].reshape(-1)))
        _close(got[i].numpy(), want, f"row {i}")


def test_componentwise_scaling_and_coordinate_locking_match_reference():
    rng = np.random.default_rng(6)
    move = rng.standard_normal((_B, _D))
    lock = (rng.uniform(size=(_B, _D)) > 0.6).astype(float)
    _close(enh.componentwise_scaling(torch.as_tensor(move), 0.4).numpy(),
           ref.componentwise_scaling(jnp.asarray(move), 0.4), "scaling")
    _close(enh.coordinate_locking(torch.as_tensor(move),
                                  torch.as_tensor(lock)).numpy(),
           ref.coordinate_locking(jnp.asarray(move), jnp.asarray(lock)),
           "locking")


def test_perturb_move_is_the_reference_formula_on_its_draw():
    rng = np.random.default_rng(7)
    move = torch.as_tensor(rng.standard_normal((_B, 3, 3)))
    got = enh.perturb_move(move, torch.Generator().manual_seed(11),
                           magnitude=1e-2)
    noise = torch.randn(move.shape, generator=torch.Generator().manual_seed(
        11), dtype=move.dtype).numpy()
    for i in range(_B):
        m = move[i].numpy()
        want = m + 1e-2 * noise[i] * np.linalg.norm(m) / (
            np.linalg.norm(noise[i]) + 1e-30)
        _close(got[i].numpy(), want, f"row {i}")


# H2O2: 4 atoms with a torsion; bonds only, so bends and the torsion lie
# in the null space of B and pass through the correction unchanged
_H2O2 = np.array([[0.0, 1.32, -0.1], [0.0, -1.32, -0.1],
                  [1.65, 1.75, 0.75], [-1.55, -1.80, 0.85]])


@pytest.mark.parametrize("with_angles", [False, True])
def test_geodesic_correct_move_matches_reference(with_angles):
    bonds = [(0, 1), (0, 2), (1, 3)]
    angles = [(2, 0, 1), (0, 1, 3)] if with_angles else []
    rng = np.random.default_rng(8)
    coords = _H2O2[None] + 0.05 * rng.standard_normal((2, 4, 3))
    move = 0.08 * rng.standard_normal((2, 12))
    ic = InternalCoordinates(bonds, angles, n_atoms=4)
    ric = RefIC(bonds, angles, n_atoms=4)
    got = enh.geodesic_correct_move(torch.as_tensor(move),
                                    torch.as_tensor(coords), ic)
    for i in range(2):
        want = ref.geodesic_correct_move(jnp.asarray(move[i]),
                                         jnp.asarray(coords[i]), ric)
        _close(got[i].numpy(), want, f"row {i}", rtol=0, atol=1e-9)
    assert not np.allclose(got.numpy(), move)
