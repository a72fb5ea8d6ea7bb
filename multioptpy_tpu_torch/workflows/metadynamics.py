"""Metadynamics: MD with Gaussian hills deposited on a bond collective
variable.

Counterpart of `multioptpy_tpu/workflows/metadynamics.py`: the trajectory
runs in `run_md` chunks of `deposit_every` steps and a hill is deposited
on the `gaussian_metadyn` potential between chunks (its padded hill buffer
keeps the energy's shape fixed). `run_md` draws from a `torch.Generator`,
which cannot replay `jax.random`; `velocities` and `noise` let a caller
pass another run's initial velocities and Langevin draws.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.drivers.md import MDConfig, run_md
from multioptpy_tpu_torch.potentials import BiasEngine, get_potential


@dataclasses.dataclass(frozen=True)
class MetadynamicsConfig:
    md: MDConfig = dataclasses.field(default_factory=lambda: MDConfig(
        thermostat="langevin", temperature=300.0, timestep_fs=0.5))
    height_kjmol: float = 2.0
    width_ang: float = 0.2
    deposit_every: int = 50     # MD steps between hills
    n_hills: int = 100
    cv_atom_pair: tuple = (1, 2)


class MetadynamicsResult(NamedTuple):
    trajectory: np.ndarray
    cv_history: np.ndarray       # CV at every deposit
    hill_centers: np.ndarray
    free_energy_cv: np.ndarray   # grid of CV values
    free_energy: np.ndarray      # -sum of hills on the grid (kJ/mol)


def run_metadynamics(calc, coords, z, config=MetadynamicsConfig(),
                     extra_bias=None, velocities=None, noise=None,
                     device=None):
    """Standard (not well-tempered) metadynamics on a bond CV.

    `velocities` (N,3) start the first chunk (else `run_md` draws them);
    `noise`, if given, holds each chunk's Langevin draws (n_hills,
    deposit_every, N, 3). `device` (None means the CUDA card) must be where
    `calc` lives."""
    dev = calc_device(calc, device, "the metadynamics")
    pot = get_potential("gaussian_metadyn",
                        height_kjmol=config.height_kjmol,
                        width_ang=config.width_ang,
                        atom_pair=list(config.cv_atom_pair),
                        max_hills=config.n_hills + 1)
    coords = on_device(coords, dev)
    z = np.asarray(z)
    cv_hist = []
    frames = []
    md_cfg = dataclasses.replace(config.md, n_steps=config.deposit_every)
    for i in range(config.n_hills):
        pots = [pot] + (list(extra_bias.potentials) if extra_bias else [])
        engine = BiasEngine(pots)
        res = run_md(calc, coords, z, md_cfg, bias_engine=engine,
                     velocities=velocities,
                     noise=None if noise is None else noise[i], device=dev)
        coords = torch.as_tensor(res.trajectory[-1], device=dev)
        velocities = res.final.velocities
        cv = float(pot.cv(coords))
        pot.deposit(cv)
        cv_hist.append(cv)
        frames.append(res.trajectory[-1])

    centers = pot.centers[: pot.n_hills]
    grid = np.linspace(max(centers.min() - 1.0, 0.1), centers.max() + 1.0,
                       200)
    hills = config.height_kjmol * np.exp(
        -(grid[:, None] - centers[None, :]) ** 2
        / (2.0 * (pot.width) ** 2))
    free_energy = -hills.sum(axis=1)

    return MetadynamicsResult(
        trajectory=np.stack(frames), cv_history=np.asarray(cv_hist),
        hill_centers=centers.copy(), free_energy_cv=grid,
        free_energy=free_energy)
