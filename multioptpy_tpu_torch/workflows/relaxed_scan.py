"""Relaxed potential-energy-surface scan.

Counterpart of `multioptpy_tpu/workflows/relaxed_scan.py`: a linspace over
a bond / angle / dihedral target (or several targets in lockstep), each
point a constrained `optimize` seeded from the previous point's geometry
(or, with `first_only`, from the input).
"""

from typing import NamedTuple

import numpy as np

from multioptpy_tpu_torch.constraints import Constraints
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize


class ScanResult(NamedTuple):
    values: np.ndarray          # scanned coordinate values (input units)
    energies: np.ndarray        # (P,)
    geometries: np.ndarray      # (P,N,3)
    converged: np.ndarray       # (P,) bool


def _constraint_for(kind, atoms, value):
    if kind == "bond":
        return {"bonds": [(atoms[0], atoms[1], float(value))]}
    if kind == "angle":
        return {"angles": [(atoms[0], atoms[1], atoms[2], float(value))]}
    if kind == "dihedral":
        return {"dihedrals": [(atoms[0], atoms[1], atoms[2], atoms[3],
                               float(value))]}
    raise ValueError(f"unknown scan kind '{kind}'")


def _scan(calc, coords, z, rows, constraints_of, config, bias_engine,
          first_only, device):
    """One constrained optimization per row of `rows`."""
    geoms, energies, convs = [], [], []
    current = coords
    for row in rows:
        res = optimize(calc, current, z, bias_engine=bias_engine,
                       config=config, constraints=constraints_of(row),
                       device=device)
        current = coords if first_only else res.coords
        geoms.append(res.coords.cpu().numpy())
        energies.append(float(res.energy))
        convs.append(bool(res.converged))
    return np.asarray(energies), np.stack(geoms), np.asarray(convs)


def relaxed_scan(calc, coords, z, kind, atoms, start, stop, n_points,
                 config=OptimizeConfig(), bias_engine=None, device=None):
    """Scan one internal coordinate.

    kind: "bond" (Angstrom) | "angle" | "dihedral" (degrees); atoms: 1-based
    atom indices (2/3/4 of them). Each point is a constrained optimize,
    seeded from the previous geometry. `device` (None means the CUDA card)
    must be where `calc` lives."""
    values = np.linspace(start, stop, n_points)
    if kind not in ("bond", "angle", "dihedral"):
        raise ValueError(f"unknown scan kind '{kind}'")
    energies, geoms, convs = _scan(
        calc, coords, z, values,
        lambda val: Constraints(**_constraint_for(kind, atoms, val)),
        config, bias_engine, False, device)
    return ScanResult(values=values, energies=energies, geometries=geoms,
                      converged=convs)


def relaxed_scan_multi(calc, coords, z, targets, n_points,
                       config=OptimizeConfig(), bias_engine=None,
                       first_only=False, device=None):
    """Scan several internal coordinates simultaneously (the repeated
    `-scan kind atoms v1,v2` triples): all targets move in lockstep along
    their own linspace and every point is one constrained optimization.

    targets: list of (kind, atoms, start, stop) with 1-based atom indices;
    first_only: seed every point from the input structure instead of the
    previous point (-fo). Returns a ScanResult whose `values` has shape
    (P, len(targets))."""
    targets = list(targets)
    if not targets:
        raise ValueError("no scan targets")
    grids = np.stack([np.linspace(start, stop, n_points)
                      for (_, _, start, stop) in targets], axis=1)  # (P,T)

    def constraints_of(row):
        merged = {"bonds": [], "angles": [], "dihedrals": []}
        for (kind, atoms, _, _), val in zip(targets, row):
            for key, items in _constraint_for(kind, atoms, val).items():
                merged[key].extend(items)
        return Constraints(**merged)

    energies, geoms, convs = _scan(calc, coords, z, grids, constraints_of,
                                   config, bias_engine, first_only, device)
    return ScanResult(values=grids, energies=energies, geometries=geoms,
                      converged=convs)
