"""Minimal periodic-boundary-condition utilities.

Counterpart of `multioptpy_tpu/pbc.py`: minimum-image wrapping, for
orthorhombic and triclinic cells. `torch.round` rounds half to even, as
`jnp.round` does.
"""

import torch


def wrap_coordinates(coords, cell):
    """Wrap (..., N, 3) Cartesian coords into the primary cell. cell:
    (3, 3), rows are the lattice vectors (Bohr)."""
    cell = torch.as_tensor(cell, dtype=coords.dtype, device=coords.device)
    frac = coords @ torch.linalg.inv(cell)
    frac = frac - torch.floor(frac)
    return frac @ cell


def minimum_image_displacement(d, cell):
    """The minimum-image convention on displacement vectors (..., 3)."""
    cell = torch.as_tensor(cell, dtype=d.dtype, device=d.device)
    frac = d @ torch.linalg.inv(cell)
    frac = frac - torch.round(frac)
    return frac @ cell


def pairwise_distances_pbc(coords, cell):
    """(..., N, 3) -> (..., N, N) minimum-image distance matrix."""
    d = coords[..., :, None, :] - coords[..., None, :, :]
    d = minimum_image_displacement(d, cell)
    n = coords.shape[-2]
    return torch.sqrt((d * d).sum(-1)
                      + torch.eye(n, dtype=coords.dtype,
                                  device=coords.device) * 1e-30)
