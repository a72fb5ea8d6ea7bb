"""Port parity: multioptpy_tpu_torch.drivers.md against the JAX package on
an Ar4 cluster (Lennard-Jones, f64): every thermostat from the same
initial velocities (numpy, seeded) to 1e-10 relative over 20-50 steps,
the Nose-Hoover chain with n_chain=3 over 50, Langevin on the reference's
own jax.random draws, SHAKE on a bond, the periodic fragment wrap and the
chunked -ct schedule with velocities carried; maxwell_boltzmann against
its formula on its own draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.constraints import Constraints as RefConstraints
from multioptpy_tpu.drivers import md as ref_md
from multioptpy_tpu.periodic import UFF_VDW_R
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.constraints import Constraints
from multioptpy_tpu_torch.drivers import md
from multioptpy_tpu_torch.geometry import masses_from_z
from multioptpy_tpu_torch.units import AMU2AU, KB_HARTREE

torch.set_num_threads(1)

_R = float(UFF_VDW_R[18])
_AR4 = np.array([[0.0, 0.0, 0.0], [_R, 0.1, 0.0],
                 [_R / 2, _R * 0.866, 0.2],
                 [_R / 2, _R * 0.289, _R * 0.816]])
_Z = np.full(4, 18)


def _v0(seed=3, temperature=60.0):
    m = masses_from_z(_Z).numpy() * AMU2AU
    sigma = np.sqrt(KB_HARTREE * temperature / m)[:, None]
    return sigma * np.random.default_rng(seed).standard_normal((4, 3))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-300)


def _both(cfg_kw, v0=None, ref_kw=None, port_kw=None):
    v0 = _v0() if v0 is None else v0
    ref = ref_md.run_md(RefLJ(), jnp.asarray(_AR4), jnp.asarray(_Z),
                        ref_md.MDConfig(**cfg_kw),
                        velocities=jnp.asarray(v0), **(ref_kw or {}))
    got = md.run_md(LennardJones(device="cpu"), torch.as_tensor(_AR4), _Z,
                    md.MDConfig(**cfg_kw), velocities=torch.as_tensor(v0),
                    device="cpu", **(port_kw or {}))
    return ref, got


def _assert_same(ref, got):
    assert got.trajectory.shape == np.asarray(ref.trajectory).shape
    assert _rel(got.trajectory, ref.trajectory) < 1e-10
    assert _rel(got.energies, ref.energies) < 1e-10
    assert _rel(got.temperatures, ref.temperatures) < 1e-10
    assert _rel(got.final.velocities.numpy(), ref.final.velocities) < 1e-10
    assert _rel(got.final.xi.numpy(), ref.final.xi) < 1e-10


@pytest.mark.parametrize("thermostat,n_steps,extra", [
    ("none", 30, {}),
    ("nosehoover", 30, {}),
    ("nosehooverchain", 50, {"n_chain": 3}),
    ("berendsen", 30, {}),
])
def test_deterministic_thermostats_match_reference(thermostat, n_steps,
                                                   extra):
    ref, got = _both(dict(timestep_fs=2.0, n_steps=n_steps,
                          temperature=120.0, thermostat=thermostat,
                          tau_fs=20.0, **extra))
    _assert_same(ref, got)


def test_langevin_matches_reference_on_its_draws():
    n_steps, seed = 20, 5
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (4, 3),
                                                  dtype=jnp.float64)))
    ref, got = _both(dict(timestep_fs=2.0, n_steps=n_steps, temperature=90.0,
                          thermostat="langevin", friction_fs=0.05,
                          seed=seed),
                     port_kw={"noise": torch.as_tensor(np.stack(draws))})
    _assert_same(ref, got)


def test_shake_bond_and_pbc_wrap_match_reference():
    cfg = dict(timestep_fs=2.0, n_steps=20, temperature=100.0,
               thermostat="nosehoover")
    ref, got = _both(cfg, ref_kw={"constraints": RefConstraints(
        bonds=[(1, 2, None)])},
        port_kw={"constraints": Constraints(bonds=[(1, 2, None)])})
    _assert_same(ref, got)
    d12 = np.linalg.norm(got.trajectory[:, 0] - got.trajectory[:, 1], axis=1)
    np.testing.assert_allclose(d12, np.linalg.norm(_AR4[0] - _AR4[1]),
                               rtol=1e-9)
    # a 2 Angstrom box: each Ar is its own fragment and wraps
    ref, got = _both(dict(cfg, thermostat="none", pbc_box_ang=(2.0, 2.0,
                                                               2.0)))
    _assert_same(ref, got)
    box = 2.0 / 0.52917721067
    assert (got.trajectory >= -1e-12).all()
    assert (got.trajectory <= box + 1e-12).all()


def test_pbc_wrap_keeps_bonded_fragments_whole():
    x = torch.tensor([[0.0, 0.0, 0.0], [1.4, 0.0, 0.0], [9.0, 9.0, 9.0]],
                     dtype=torch.float64)
    z = np.array([1, 1, 1])
    wrap = md.make_fragment_pbc_wrap(x, z, (3.0, 3.0, 3.0))
    ref_wrap = ref_md.make_fragment_pbc_wrap(jnp.asarray(x.numpy()),
                                             jnp.asarray(z), (3.0, 3.0, 3.0))
    moved = x + torch.tensor([-0.5, 7.0, 0.3], dtype=torch.float64)
    got = wrap(moved)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_wrap(jnp.asarray(
                                   moved.numpy()))), rtol=0, atol=1e-12)
    assert float(torch.linalg.vector_norm(got[0] - got[1])) == \
        pytest.approx(1.4, abs=1e-12)


def test_chunked_schedule_carries_velocities():
    """Two chunks at 80 K then 200 K, velocities carried (mdmain -ct),
    against the reference's two chunks."""
    v = _v0()
    rx, px = jnp.asarray(_AR4), torch.as_tensor(_AR4)
    rv, pv = jnp.asarray(v), torch.as_tensor(v)
    for temp, n in ((80.0, 12), (200.0, 9)):
        cfg = dict(timestep_fs=2.0, n_steps=n, temperature=temp,
                   thermostat="berendsen", tau_fs=10.0)
        ref = ref_md.run_md(RefLJ(), rx, jnp.asarray(_Z),
                            ref_md.MDConfig(**cfg), velocities=rv)
        got = md.run_md(LennardJones(device="cpu"), px, _Z,
                        md.MDConfig(**cfg), velocities=pv, device="cpu")
        _assert_same(ref, got)
        rx, rv = ref.final.coords, ref.final.velocities
        px, pv = got.final.coords, got.final.velocities


def test_maxwell_boltzmann_follows_its_formula_and_seed():
    m = torch.as_tensor(masses_from_z(_Z).numpy() * AMU2AU)
    g1 = torch.Generator().manual_seed(7)
    v = md.maxwell_boltzmann(g1, m, 300.0)
    g2 = torch.Generator().manual_seed(7)
    draw = torch.randn((4, 3), generator=g2, dtype=torch.float64)
    sigma = torch.sqrt(KB_HARTREE * 300.0 / m)[:, None]
    torch.testing.assert_close(v, sigma * draw, rtol=1e-15, atol=0.0)
    assert float(md.instantaneous_temperature(v, m)) == pytest.approx(
        float(ref_md.instantaneous_temperature(jnp.asarray(v.numpy()),
                                               jnp.asarray(m.numpy()))),
        rel=1e-13)
    # no velocities: the run draws them from config.seed, reproducibly
    runs = [md.run_md(LennardJones(device="cpu"), _AR4, _Z,
                      md.MDConfig(n_steps=3, thermostat="langevin", seed=4),
                      device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(runs[0].trajectory, runs[1].trajectory)


def test_run_md_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        md.run_md(LennardJones(device="cpu"), _AR4, _Z, md.MDConfig(n_steps=1))
