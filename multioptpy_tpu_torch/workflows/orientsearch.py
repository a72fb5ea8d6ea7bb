"""Orientation search: random rigid-body placements of a fragment.

Counterpart of `multioptpy_tpu/workflows/orientsearch.py`: N random
orientations (rotation + translation) of the mobile fragment, drawn with
the same numpy draws in the same order, all optimized together as one
batch.
"""

from typing import NamedTuple

import numpy as np

from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize_batch
from multioptpy_tpu_torch.units import ANGSTROM2BOHR


class OrientResult(NamedTuple):
    geometries: np.ndarray     # (S,N,3) energy-sorted
    energies: np.ndarray


def _random_rotation(rng):
    # uniform rotation via QR of a Gaussian matrix
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.diag(r))


def orientation_samples(coords, fragment_atoms, n_samples=16, max_shift=2.0,
                        seed=0, distance_ang=None):
    """The (S,N,3) starting placements `orientation_search` optimizes."""
    rng = np.random.default_rng(seed)
    coords_np = np.asarray(coords)
    idx = np.asarray(fragment_atoms) - 1
    rest = np.setdiff1d(np.arange(len(coords_np)), idx)

    place_center = None
    if distance_ang is not None and len(rest):
        rest_center = coords_np[rest].mean(axis=0)
        axis = coords_np[idx].mean(axis=0) - rest_center
        nrm = np.linalg.norm(axis)
        axis = axis / nrm if nrm > 1e-8 else np.array([1.0, 0.0, 0.0])
        place_center = rest_center + axis * distance_ang * ANGSTROM2BOHR

    samples = []
    for _ in range(n_samples):
        new = coords_np.copy()
        frag = coords_np[idx]
        center = frag.mean(axis=0)
        if place_center is not None:
            frag = frag - center + place_center
            center = place_center
        rot = _random_rotation(rng)
        shift = rng.uniform(-max_shift, max_shift, size=3)
        new[idx] = (frag - center) @ rot.T + center + shift
        # reject overlapping placements by re-drawing the shift
        for _retry in range(20):
            d = np.linalg.norm(new[idx][:, None] - new[rest][None, :],
                               axis=-1) if len(rest) else np.array([[9.9]])
            if d.min() > 1.5:
                break
            shift = rng.uniform(-max_shift, max_shift, size=3)
            new[idx] = (frag - center) @ rot.T + center + shift
        samples.append(new)
    return np.stack(samples)


def orientation_search(calc, coords, z, fragment_atoms, n_samples=16,
                       config=OptimizeConfig(), bias_engine=None,
                       max_shift=2.0, n_opt_steps=100, seed=0,
                       distance_ang=None, device=None):
    """fragment_atoms: 1-based indices of the mobile fragment.

    distance_ang: place the fragment's center this many Angstrom from the
    center of the remaining atoms (along the original separation axis)
    before sampling orientations. `device` (None means the CUDA card) must
    be where `calc` lives."""
    if hasattr(coords, "detach"):
        coords = coords.detach().cpu().numpy()
    batch = orientation_samples(coords, fragment_atoms, n_samples,
                                max_shift, seed, distance_ang)
    res = optimize_batch(calc, batch, np.asarray(z), bias_engine=bias_engine,
                         config=config, n_steps=n_opt_steps, device=device)
    e = res.energy.cpu().numpy()
    order = np.argsort(e)
    return OrientResult(geometries=res.coords.cpu().numpy()[order],
                        energies=e[order])
