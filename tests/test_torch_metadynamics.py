"""Port parity: multioptpy_tpu_torch.workflows.metadynamics against the
JAX package on the LJ dimer of tests/test_metadynamics.py (Langevin, 12
hills of 25 steps): the port is handed the reference's own jax.random
draws (its initial velocities, then each chunk's Langevin noise), and the
trajectory, CV history, hill centers and free-energy grid agree to 1e-10
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multioptpy_tpu.calculators import LennardJones as RefLJ
from multioptpy_tpu.drivers import md as ref_md
from multioptpy_tpu.periodic import UFF_VDW_R
from multioptpy_tpu.workflows import metadynamics as ref
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.drivers.md import MDConfig
from multioptpy_tpu_torch.geometry import masses_from_z
from multioptpy_tpu_torch.units import AMU2AU
from multioptpy_tpu_torch.workflows import metadynamics

torch.set_num_threads(1)

RMIN = float(UFF_VDW_R[18])
_MD = dict(thermostat="langevin", temperature=40.0, timestep_fs=3.0,
           friction_fs=0.05, seed=7)
_CFG = dict(height_kjmol=1.5, width_ang=0.25, deposit_every=25, n_hills=12,
            cv_atom_pair=(1, 2))


def _reference_draws(z, n_hills, n_steps, seed):
    """The velocities and per-chunk Langevin draws of the reference's
    `run_metadynamics`: every chunk's `run_md` starts from PRNGKey(seed);
    the first splits once for the Maxwell-Boltzmann velocities, and every
    step splits once for its noise."""
    m = jnp.asarray(masses_from_z(z).numpy() * AMU2AU)
    noise = []
    v0 = None
    for i in range(n_hills):
        key = jax.random.PRNGKey(seed)
        if i == 0:
            key, sub = jax.random.split(key)
            v0 = np.asarray(ref_md.maxwell_boltzmann(sub, m, _MD[
                "temperature"], jnp.float64))
        chunk = []
        for _ in range(n_steps):
            key, sub = jax.random.split(key)
            chunk.append(np.asarray(jax.random.normal(sub, (len(z), 3),
                                                      dtype=jnp.float64)))
        noise.append(np.stack(chunk))
    return v0, np.stack(noise)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-300)


def test_metadynamics_on_the_reference_draws():
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, RMIN]])
    z = np.array([18, 18])
    want = ref.run_metadynamics(
        RefLJ(), jnp.asarray(coords), jnp.asarray(z),
        ref.MetadynamicsConfig(md=ref_md.MDConfig(**_MD), **_CFG))
    v0, noise = _reference_draws(z, _CFG["n_hills"], _CFG["deposit_every"],
                                 _MD["seed"])
    got = metadynamics.run_metadynamics(
        LennardJones(device="cpu"), torch.as_tensor(coords), z,
        metadynamics.MetadynamicsConfig(md=MDConfig(**_MD), **_CFG),
        velocities=torch.as_tensor(v0), noise=torch.as_tensor(noise),
        device="cpu")
    assert got.hill_centers.shape == (12,)
    assert got.cv_history.std() > 0.0
    for name in ("trajectory", "cv_history", "hill_centers",
                 "free_energy_cv", "free_energy"):
        assert _rel(getattr(got, name), getattr(want, name)) < 1e-10, name
    i_min = np.argmin(np.abs(got.free_energy_cv - RMIN))
    assert got.free_energy[i_min] < -1e-3
