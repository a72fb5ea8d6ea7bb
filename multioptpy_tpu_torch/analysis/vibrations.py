"""Normal-mode analysis and RRHO thermochemistry.

Counterpart of `multioptpy_tpu/analysis/vibrations.py`: mass-weighted,
TR/rot-projected normal modes, their display metadata, the
`normal_modes.txt` table and the per-mode animation files of `optmain
-freq`, rotational constants, and rigid-rotor harmonic-oscillator
thermochemistry. Frequencies follow the quantum-chemistry convention
(imaginary modes as negative cm^-1). `normal_modes` takes one structure
((3N,3N), (N,3)) or a batch ((B,3N,3N), (B,N,3)); the writers and the
thermochemistry take one structure and work in host numpy, as the
reference does.
"""

import os
from typing import NamedTuple

import numpy as np
import torch

from multioptpy_tpu_torch.geometry import (center_of_mass, masses_from_z,
                                           project_hessian_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.ops.eigh64 import eigh_deflated, eigh_fast
from multioptpy_tpu_torch.periodic import z_to_symbol
from multioptpy_tpu_torch.units import (AMU2KG, BOHR2ANGSTROM, BOHR2M,
                                        HARTREE2J, KB_HARTREE,
                                        LIGHT_SPEED_M_S, PLANCK_J_S)

# sqrt(Hartree / (Bohr^2 amu)) -> angular frequency (1/s)
_OMEGA_SI = np.sqrt(HARTREE2J / (BOHR2M ** 2 * AMU2KG))
# angular frequency -> wavenumber (cm^-1)
_TO_CM1 = 1.0 / (2.0 * np.pi * LIGHT_SPEED_M_S * 100.0)


class NormalModes(NamedTuple):
    frequencies_cm1: torch.Tensor   # (..., 3N), TR/rot ~0, imaginary < 0
    modes: torch.Tensor             # (..., 3N, N, 3) Cartesian modes
    eigenvalues: torch.Tensor       # mass-weighted Hessian eigenvalues


def normal_modes(hessian, coords, z):
    """Mass-weighted, TR/rot-projected normal modes."""
    single = coords.ndim == 2
    if single:
        hessian, coords = hessian[None], coords[None]
    b, n, _ = coords.shape
    masses = masses_from_z(z).to(device=coords.device, dtype=coords.dtype)
    sm = torch.repeat_interleave(torch.sqrt(masses), 3)
    h_mw = hessian / sm[:, None] / sm[None, :]
    if n > 1:
        p = tr_rot_projector(coords, masses)
        h_mw = project_hessian_tr_rot(h_mw, coords, masses)
        w, v = eigh_deflated(h_mw, p)
    else:
        w, v = eigh_fast(h_mw)
    freq = torch.sign(w) * torch.sqrt(w.abs()) * (_OMEGA_SI * _TO_CM1)
    cart_modes = (v / sm[:, None]).mT.reshape(b, 3 * n, n, 3)
    nm = NormalModes(frequencies_cm1=freq, modes=cart_modes, eigenvalues=w)
    return NormalModes(*(x[0] for x in nm)) if single else nm


def count_imaginary(freqs_cm1, thresh=-5.0):
    """Number of true imaginary modes (below -5 cm^-1 to skip TR/rot noise):
    an int for one structure's (3N,), a (B,) tensor for a batch."""
    n = (torch.as_tensor(freqs_cm1) < thresh).sum(-1)
    return int(n) if n.ndim == 0 else n


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class ModeMetadata(NamedTuple):
    indices: np.ndarray          # into NormalModes arrays, sorted ascending
    frequencies_cm1: np.ndarray  # imaginary negative
    reduced_mass: np.ndarray     # amu
    force_const_dyne: np.ndarray  # mdyne/Angstrom display units
    vib_temperature: np.ndarray  # K (|freq|; sign carried by frequency)


def mode_metadata(nm, cutoff_freq=10.0, include_imag=True):
    """Per-mode display quantities of one structure's modes: the modes
    with |freq| > cutoff (TR/rot residue dropped; only freq > cutoff
    without `include_imag`), sorted ascending so imaginary modes lead."""
    freqs = _np(nm.frequencies_cm1)
    keep = np.abs(freqs) > cutoff_freq if include_imag \
        else freqs > cutoff_freq
    idx = np.where(keep)[0][np.argsort(freqs[keep])]
    modes = _np(nm.modes)[idx]          # (M, N, 3) Cartesian
    red_mass = 1.0 / np.sum(modes * modes, axis=(1, 2))
    evals = _np(nm.eigenvalues)[idx]
    dyne = 1e-2 * HARTREE2J / BOHR2M ** 2
    kb_j = KB_HARTREE * HARTREE2J
    vib_t = (np.abs(freqs[idx]) * 100.0 * LIGHT_SPEED_M_S *
             PLANCK_J_S / kb_j)
    return ModeMetadata(indices=idx, frequencies_cm1=freqs[idx],
                        reduced_mass=red_mass,
                        force_const_dyne=red_mass * evals * dyne,
                        vib_temperature=vib_t)


def write_normal_modes(nm, z, path, cutoff_freq=10.0, include_imag=True):
    """normal_modes.txt: per chunk of 3 modes, the rows Freq / Reduced
    mass / Force const / Char temp, then each atom's x y z displacement
    columns."""
    meta = mode_metadata(nm, cutoff_freq, include_imag)
    modes = _np(nm.modes)[meta.indices]
    syms = [z_to_symbol(int(zi)) for zi in np.asarray(z)]
    nfreq = len(meta.indices)
    lines = []
    for col0 in range(0, nfreq, 3):
        col1 = min(col0 + 3, nfreq)
        lines.append("Mode              " + "".join(
            "%20d" % i for i in range(col0, col1)))
        lines.append("Freq [cm^-1]          " + "".join(
            f"{meta.frequencies_cm1[i]:20.4f}" for i in range(col0, col1)))
        lines.append("Reduced mass [au]     " + "".join(
            f"{meta.reduced_mass[i]:20.4f}" for i in range(col0, col1)))
        lines.append("Force const [Dyne/A]  " + "".join(
            f"{meta.force_const_dyne[i]:20.4f}" for i in range(col0, col1)))
        lines.append("Char temp [K]         " + "".join(
            f"{meta.vib_temperature[i]:20.4f}" for i in range(col0, col1)))
        lines.append("Normal mode            " +
                     "       x         y         z     " * (col1 - col0))
        for j, sym in enumerate(syms):
            row = f"    {sym:>4s}               "
            for i in range(col0, col1):
                x, y, zz = modes[i, j]
                row += f"{x:10.5f}{y:10.5f}{zz:10.5f}    "
            lines.append(row)
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_mode_animations(nm, coords, z, output_dir, n_frames=20,
                          amplitude=0.5, cutoff_freq=10.0,
                          include_imag=True):
    """One xyz animation per mode, mode_{k}_{freq}_wave_number.xyz: a
    sinusoidal displacement over n_frames, in Angstrom. Imaginary modes
    carry the '<mag>i' frequency tag."""
    os.makedirs(output_dir, exist_ok=True)
    meta = mode_metadata(nm, cutoff_freq, include_imag)
    modes = _np(nm.modes)[meta.indices]
    coords = _np(coords)
    syms = [z_to_symbol(int(zi)) for zi in np.asarray(z)]
    paths = []
    for k, freq in enumerate(meta.frequencies_cm1):
        freq_str = (f"{abs(freq):.0f}i" if freq < 0.0 else f"{freq:.0f}")
        path = os.path.join(
            output_dir, f"mode_{k + 1}_{freq_str}_wave_number.xyz")
        vec = modes[k]
        with open(path, "w") as f:
            for frame in range(n_frames):
                phase = 2.0 * np.pi * frame / (n_frames - 1)
                disp = coords + amplitude * np.sin(phase) * vec
                f.write(f"{len(syms)}\n")
                f.write(f"Mode {k + 1}, Freq: {freq_str} cm-1, "
                        f"Frame: {frame + 1}/{n_frames}\n")
                for sym, (x, y, zz) in zip(syms, disp * BOHR2ANGSTROM):
                    f.write(f"{sym} {x:.6f} {y:.6f} {zz:.6f}\n")
        paths.append(path)
    return paths


def rotational_constants(coords, z):
    """Principal moments of inertia of coords (N, 3) -> (rotational
    constants in cm^-1, moments in amu Bohr^2), each (3,)."""
    masses = masses_from_z(z).to(device=coords.device, dtype=coords.dtype)
    xyz = coords - center_of_mass(coords, masses)
    x, y, zz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    m = masses
    ixx = (m * (y * y + zz * zz)).sum()
    iyy = (m * (x * x + zz * zz)).sum()
    izz = (m * (x * x + y * y)).sum()
    ixy = -(m * x * y).sum()
    ixz = -(m * x * zz).sum()
    iyz = -(m * y * zz).sum()
    inertia = torch.stack([torch.stack([ixx, ixy, ixz]),
                           torch.stack([ixy, iyy, iyz]),
                           torch.stack([ixz, iyz, izz])])
    moments = torch.linalg.eigvalsh(inertia)   # amu Bohr^2
    moments_si = moments * AMU2KG * BOHR2M ** 2
    b = PLANCK_J_S / (8.0 * np.pi ** 2 * LIGHT_SPEED_M_S * 100.0 *
                      moments_si.clamp(min=1e-60))
    return b, moments


class Thermochemistry(NamedTuple):
    zpe: float                 # Hartree
    e_thermal: float           # U_vib + U_rot + U_trans (incl. ZPE)
    enthalpy: float            # H = U + kT
    entropy: float             # Hartree/K
    gibbs: float               # G = H - T S
    frequencies_cm1: np.ndarray


def rrho_thermochemistry(hessian, coords, z, temperature=298.15,
                         pressure=101325.0, multiplicity=1, sigma_rot=1,
                         freq_cutoff=10.0):
    """Rigid-rotor harmonic-oscillator thermochemistry of one structure
    (Hessian (3N, 3N), coords (N, 3)) in Hartree. Modes below
    `freq_cutoff` cm^-1 (TR/rot residue) are dropped."""
    nm = normal_modes(hessian, coords, z)
    freqs = _np(nm.frequencies_cm1)
    vib = freqs[freqs > freq_cutoff]

    kT = KB_HARTREE * temperature
    hw = vib * LIGHT_SPEED_M_S * 100.0 * PLANCK_J_S / HARTREE2J
    zpe = float(0.5 * np.sum(hw))
    x = hw / kT
    xc = np.clip(x, 1e-12, 700)
    u_vib = float(np.sum(hw * (0.5 + 1.0 / np.expm1(xc))))
    s_vib = float(KB_HARTREE * np.sum(x / np.expm1(xc)
                                      - np.log1p(-np.exp(-xc))))

    n_atoms = coords.shape[0]
    masses = _np(masses_from_z(z))
    m_total_kg = np.sum(masses) * AMU2KG

    # translation (Sackur-Tetrode)
    u_trans = 1.5 * kT
    q_trans = ((2.0 * np.pi * m_total_kg * (KB_HARTREE * HARTREE2J) *
                temperature) / PLANCK_J_S ** 2) ** 1.5 * \
        (KB_HARTREE * HARTREE2J * temperature / pressure)
    s_trans = KB_HARTREE * (np.log(q_trans) + 2.5)

    # rotation
    if n_atoms == 1:
        u_rot, s_rot = 0.0, 0.0
    else:
        b_cm, moments = rotational_constants(coords, z)
        moments = np.sort(_np(moments))
        linear = moments[0] < 1e-3 * moments[2]
        b_joule = _np(b_cm) * LIGHT_SPEED_M_S * 100.0 * PLANCK_J_S
        kT_j = KB_HARTREE * HARTREE2J * temperature
        if linear:
            u_rot = kT
            # the finite constant belongs to the two large moments
            q_rot = kT_j / (np.min(b_joule) * sigma_rot)
            s_rot = KB_HARTREE * (np.log(q_rot) + 1.0)
        else:
            u_rot = 1.5 * kT
            q_rot = (np.sqrt(np.pi) / sigma_rot) * np.sqrt(
                kT_j ** 3 / np.prod(b_joule))
            s_rot = KB_HARTREE * (np.log(q_rot) + 1.5)

    s_elec = KB_HARTREE * np.log(max(multiplicity, 1))

    u_total = u_vib + u_rot + u_trans
    h_total = u_total + kT
    s_total = s_vib + s_rot + s_trans + s_elec
    g_total = h_total - temperature * s_total

    return Thermochemistry(
        zpe=zpe, e_thermal=u_total, enthalpy=h_total, entropy=s_total,
        gibbs=g_total, frequencies_cm1=freqs)
