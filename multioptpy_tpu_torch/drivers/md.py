"""Molecular dynamics: velocity Verlet, Nose-Hoover (chain), Berendsen and
Langevin BAOAB.

Counterpart of `multioptpy_tpu/drivers/md.py`. The reference advances the
whole trajectory in one `lax.scan`; here each step is a sequence of
launches on the device, the trajectory is kept on the device and copied
to the host once at the end, so the loop makes no host sync. Bias
potentials compose exactly as in optimization. Units: a.u. throughout (dt
converted from fs).

Random draws come from an explicit `torch.Generator` (`MDState.key`), which
cannot reproduce `jax.random`'s stream: `make_md_step` and `run_md` take
the Langevin noise from the caller when given, so a run can replay
another's draws.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.device import calc_device, on_device
from multioptpy_tpu_torch.geometry import bond_connectivity, masses_from_z
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.units import AMU2AU, AU2FS, KB_HARTREE


@dataclasses.dataclass(frozen=True)
class MDConfig:
    timestep_fs: float = 0.5
    n_steps: int = 1000
    temperature: float = 300.0       # K
    thermostat: str = "nosehoover"   # none | nosehoover | nosehooverchain
                                     # | langevin | berendsen
    tau_fs: float = 50.0             # thermostat time constant
    friction_fs: float = 0.01        # Langevin gamma (1/fs)
    seed: int = 0
    n_chain: int = 3                 # Nose-Hoover chain length
    remove_com: bool = True
    # orthorhombic periodic box lengths [a b c] in Angstrom
    pbc_box_ang: tuple = ()


class MDState(NamedTuple):
    coords: torch.Tensor      # (N,3) Bohr
    velocities: torch.Tensor  # (N,3) Bohr / a.u. time
    energy: torch.Tensor
    gradient: torch.Tensor
    xi: torch.Tensor          # thermostat chain velocities (n_chain,)
    key: torch.Generator


def kinetic_energy(v, masses_au):
    return 0.5 * (masses_au[:, None] * v * v).sum()


def instantaneous_temperature(v, masses_au):
    """T = 2 KE / (dof k_B), dof = 3N - 3."""
    dof = v.numel() - 3
    return 2.0 * kinetic_energy(v, masses_au) / (dof * KB_HARTREE)


def maxwell_boltzmann(key, masses_au, temperature, dtype=torch.float64):
    """(N,3) velocities sigma_i * normal draws from the generator `key`,
    sigma_i = sqrt(k_B T / m_i)."""
    n = masses_au.shape[0]
    sigma = torch.sqrt(KB_HARTREE * temperature / masses_au)[:, None]
    return sigma * torch.randn((n, 3), generator=key, dtype=dtype,
                               device=masses_au.device)


def make_fragment_pbc_wrap(coords0, z, box_ang):
    """Molecule-preserving periodic wrap: whole covalent fragments (fixed
    from the t=0 bond connectivity) translate so each center of mass lands
    inside the orthorhombic box. Returns coords (N,3) -> coords."""
    from multioptpy_tpu_torch.coords.internals import _components
    from multioptpy_tpu_torch.units import ANGSTROM2BOHR

    z_np = np.asarray(z)
    adj = bond_connectivity(coords0.detach(), z_np).cpu().numpy()
    labels = _components(adj)
    frag_ids = sorted(set(labels))
    n = len(z_np)
    member = np.zeros((len(frag_ids), n))
    for fi, lab in enumerate(frag_ids):
        member[fi, [i for i in range(n) if labels[i] == lab]] = 1.0
    m = masses_from_z(z_np).numpy()
    com_w = member * m[None, :]
    com_w = com_w / com_w.sum(axis=1, keepdims=True)
    kind = dict(dtype=coords0.dtype, device=coords0.device)
    member_t = torch.as_tensor(member, **kind)
    com_w_t = torch.as_tensor(com_w, **kind)
    box = torch.as_tensor(np.asarray(box_ang, dtype=np.float64)
                          * ANGSTROM2BOHR, **kind)

    def wrap(x):
        com = com_w_t @ x                          # (F,3)
        shift = -torch.floor(com / box) * box      # into [0, box)
        return x + member_t.T @ shift

    return wrap


def _masses_au(z, coords):
    return (masses_from_z(np.asarray(z)) * AMU2AU).to(
        dtype=coords.dtype, device=coords.device)


def make_md_step(calc, z, config=MDConfig(), bias_engine=None,
                 constraints=None, constraint_targets=None, pbc_wrap=None):
    """-> step(state, noise=None) -> state. `noise` (N,3) is the Langevin
    step's standard-normal draw; without it the step draws from
    `state.key`."""
    dt = config.timestep_fs / AU2FS
    kT = KB_HARTREE * config.temperature
    tau = config.tau_fs / AU2FS
    gamma = config.friction_fs * AU2FS  # 1/fs -> 1/a.u.

    masses = {}     # per (dtype, device): no copy to the card a step

    def energy_grad(coords):
        e, g = hosteval.energy_and_gradient(calc, coords[None], z,
                                            bias_engine)
        return e[0], g[0]

    def step(state, noise=None):
        key = (state.coords.dtype, state.coords.device)
        if key not in masses:
            masses[key] = _masses_au(z, state.coords)
        m = masses[key]
        dof = state.velocities.numel() - 3
        v = state.velocities
        x = state.coords
        f = -state.gradient
        xi = state.xi

        if config.thermostat == "langevin":
            # BAOAB splitting (Leimkuhler-Matthews)
            if noise is None:
                noise = torch.randn(v.shape, generator=state.key,
                                    dtype=v.dtype, device=v.device)
            v = v + 0.5 * dt * f / m[:, None]
            x = x + 0.5 * dt * v
            c1 = np.exp(-gamma * dt)
            c2 = torch.sqrt((1.0 - c1 * c1) * kT / m)[:, None]
            v = c1 * v + c2 * noise
            x = x + 0.5 * dt * v
            e, g = energy_grad(x)
            v = v + 0.5 * dt * (-g) / m[:, None]
        else:
            chain = config.thermostat in ("nosehoover", "nosehooverchain")
            if chain:
                n_c = (config.n_chain
                       if config.thermostat == "nosehooverchain" else 1)
                q = [dof * kT * tau * tau] + [kT * tau * tau] * (
                    xi.shape[0] - 1)

                def chain_update(v, xi):
                    # each half-step builds a new xi from its entries: the
                    # update of xi[j] reads the already updated xi[j-1]
                    xs = list(xi.unbind())
                    ke = kinetic_energy(v, m)
                    xs[0] = xs[0] + 0.5 * dt * (2.0 * ke - dof * kT) / q[0]
                    for j in range(1, n_c):
                        gj = (q[j - 1] * xs[j - 1] ** 2 - kT) / q[j]
                        xs[j] = xs[j] + 0.5 * dt * gj
                    xi = torch.stack(xs)
                    return v * torch.exp(-dt * xi[0]), xi

                v, xi = chain_update(v, xi)
            elif config.thermostat == "berendsen":
                t_now = instantaneous_temperature(v, m)
                lam = torch.sqrt(torch.clamp(
                    1.0 + dt / tau * (config.temperature
                                      / torch.clamp(t_now, min=1.0) - 1.0),
                    min=0.0))
                v = v * lam

            # velocity Verlet
            v = v + 0.5 * dt * f / m[:, None]
            x = x + dt * v
            e, g = energy_grad(x)
            v = v + 0.5 * dt * (-g) / m[:, None]

            if chain:
                v, xi = chain_update(v, xi)

        if constraints is not None and constraint_targets is not None:
            # SHAKE positions back onto the constraint manifold, with the
            # RATTLE-style velocity correction
            x_shaken = constraints.shake(x[None], constraint_targets)[0]
            v = v + (x_shaken - x) / dt
            x = x_shaken
            e, g = energy_grad(x)

        if config.remove_com:
            p = (m[:, None] * v).sum(0)
            v = v - p[None, :] / m.sum()

        if pbc_wrap is not None:
            x = pbc_wrap(x)

        return MDState(coords=x, velocities=v, energy=e, gradient=g, xi=xi,
                       key=state.key)

    return step


class MDResult(NamedTuple):
    trajectory: np.ndarray      # (S,N,3)
    energies: np.ndarray        # potential
    temperatures: np.ndarray
    final: MDState


def run_md(calc, coords, z, config=MDConfig(), bias_engine=None,
           velocities=None, record_every=1, constraints=None, noise=None,
           device=None):
    """NVE/NVT trajectory on `device` (None means the CUDA card), where
    `calc` lives. Without `velocities` they are drawn from the Maxwell-
    Boltzmann distribution by a generator seeded with `config.seed`, which
    then draws the Langevin noise; `noise` (n_steps, N, 3) replaces those
    per-step draws."""
    dev = calc_device(calc, device, "the MD")
    coords = on_device(coords, dev)
    m = _masses_au(z, coords)
    key = torch.Generator(device=dev)
    key.manual_seed(int(config.seed))
    if velocities is None:
        velocities = maxwell_boltzmann(key, m, config.temperature,
                                       coords.dtype)
    else:
        velocities = torch.as_tensor(velocities, dtype=coords.dtype,
                                     device=dev)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=coords.dtype, device=dev)
    e0, g0 = hosteval.energy_and_gradient(calc, coords[None], z, bias_engine)

    constraint_targets = None
    if constraints is not None and constraints.n_constraints:
        if constraints.n_atoms is None:
            constraints.n_atoms = coords.shape[0]
        constraint_targets = constraints.targets(coords[None])
        coords = constraints.shake(coords[None], constraint_targets)[0]

    n_chain = config.n_chain if config.thermostat == "nosehooverchain" else 1
    state = MDState(coords=coords, velocities=velocities, energy=e0[0],
                    gradient=g0[0],
                    xi=torch.zeros(n_chain, dtype=coords.dtype, device=dev),
                    key=key)
    pbc_wrap = None
    if config.pbc_box_ang:
        pbc_wrap = make_fragment_pbc_wrap(coords, z, config.pbc_box_ang)
    step = make_md_step(calc, z, config, bias_engine, constraints,
                        constraint_targets, pbc_wrap=pbc_wrap)

    traj, es, ts = [], [], []
    for k in range(config.n_steps):
        state = step(state, None if noise is None else noise[k])
        traj.append(state.coords)
        es.append(state.energy)
        ts.append(instantaneous_temperature(state.velocities, m))
    # one copy to the host for the whole trajectory
    sl = slice(None, None, record_every)
    traj = torch.stack(traj).cpu().numpy() if traj else np.zeros(
        (0,) + tuple(coords.shape))
    es = torch.stack(es).cpu().numpy() if es else np.zeros(0)
    ts = torch.stack(ts).cpu().numpy() if ts else np.zeros(0)
    return MDResult(trajectory=traj[sl], energies=es[sl],
                    temperatures=ts[sl], final=state)
