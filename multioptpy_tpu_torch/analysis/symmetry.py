"""Point-group detection (Schoenflies symbol and rotational symmetry
number), in host numpy.

Counterpart of `multioptpy_tpu/analysis/symmetry.py`: a set of candidate
directions (principal axes, atom rays, pair midpoints, differences and
cross products, triple centroids), a census of every proper rotation C_n
(n <= 8), mirror plane, improper axis S_n and the inversion over it, then
the group-theory decision tree (linear -> icosahedral -> octahedral ->
tetrahedral -> axial families). Returns the rotational symmetry number
for RRHO thermochemistry. `optmain` prints the group after every run
unless `-nosymm` is given.
"""

from typing import NamedTuple

import numpy as np

from multioptpy_tpu_torch.geometry import masses_from_z

# what analyze_symmetry raises on a degenerate input (coincident atoms,
# non-finite coordinates); `optmain` reports these and re-raises the rest
SYMMETRY_ERRORS = (ValueError, np.linalg.LinAlgError)


class SymmetryResult(NamedTuple):
    point_group: str
    symmetry_number: int
    is_linear: bool


# rotational symmetry numbers per group family (Herzberg conventions)
_SIGMA = {"C1": 1, "Ci": 1, "Cs": 1, "T": 12, "Td": 12, "Th": 12,
          "O": 24, "Oh": 24, "I": 60, "Ih": 60, "Kh": 1,
          "C*v": 1, "D*h": 2}


def _sigma_of(pg):
    if pg in _SIGMA:
        return _SIGMA[pg]
    if pg.startswith("S"):
        return int(pg[1:]) // 2
    n = int("".join(ch for ch in pg[1:] if ch.isdigit()) or 1)
    return 2 * n if pg.startswith("D") else n


def _coincides(coords, z, transformed, tol):
    """Does the transformed structure map onto the original (same-element,
    injective matching)? Vectorized distance matrix + greedy assignment."""
    d = np.linalg.norm(transformed[:, None, :] - coords[None, :, :],
                       axis=-1)
    d[z[:, None] != z[None, :]] = np.inf
    if np.any(d.min(axis=1) > tol):
        return False
    used = np.zeros(len(coords), dtype=bool)
    for i in np.argsort(d.min(axis=1)):
        row = d[i].copy()
        row[used] = np.inf
        j = int(np.argmin(row))
        if row[j] > tol:
            return False
        used[j] = True
    return True


def _rotation_matrix(axis, angle):
    axis = axis / (np.linalg.norm(axis) + 1e-30)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _reflection_matrix(normal):
    nrm = normal / (np.linalg.norm(normal) + 1e-30)
    return np.eye(3) - 2.0 * np.outer(nrm, nrm)


def _unit(v):
    n = np.linalg.norm(v)
    return v / n if n > 1e-6 else None


def _candidate_directions(coords, principal_axes, cap=600):
    """Axis/normal candidates: principal axes, atom rays, pair midpoints,
    pair differences (mirror normals / perpendicular C2s), pair cross
    products (normals of planes through two atoms and the origin), and
    same-element triple centroids (C3 axes through face centers)."""
    cands = [principal_axes[:, i] for i in range(3)]
    n = len(coords)
    for p in coords:
        u = _unit(p)
        if u is not None:
            cands.append(u)
    idx = np.arange(n)
    for i in idx:
        for j in idx[i + 1:]:
            for vec in (coords[i] + coords[j],        # midpoint ray
                        coords[i] - coords[j],        # bisecting normal
                        np.cross(coords[i], coords[j])):
                u = _unit(vec)
                if u is not None:
                    cands.append(u)
            if len(cands) > 4 * cap:
                break
        if len(cands) > 4 * cap:
            break
    if n <= 30:
        for i in idx:
            for j in idx[i + 1:]:
                for k in idx[j + 1:]:
                    u = _unit(coords[i] + coords[j] + coords[k])
                    if u is not None:
                        cands.append(u)
            if len(cands) > 8 * cap:
                break
    # dedupe by |dot| ~ 1 (sign-free: an axis and its negative coincide)
    uniq = []
    arr = None
    for c in cands:
        if arr is None:
            uniq.append(c)
            arr = np.array([c])
        else:
            if np.max(np.abs(arr @ c)) < 1.0 - 1e-4:
                uniq.append(c)
                arr = np.vstack([arr, c])
        if len(uniq) >= cap:
            break
    return uniq


def analyze_symmetry(coords, z, tol=0.05, max_n_fold=8):
    """coords (N, 3) Bohr, z (N,) -> SymmetryResult."""
    coords = np.asarray(coords, dtype=np.float64)
    z = np.asarray(z)
    n = len(coords)
    if n == 1:
        return SymmetryResult("Kh", 1, False)

    masses = masses_from_z(z).numpy()
    com = (coords * masses[:, None]).sum(0) / masses.sum()
    x = coords - com

    inertia = np.zeros((3, 3))
    for mi, p in zip(masses, x):
        inertia += mi * (np.dot(p, p) * np.eye(3) - np.outer(p, p))
    moments, axes = np.linalg.eigh(inertia)

    has_inversion = _coincides(x, z, -x, tol)
    if moments[0] < 1e-4 * max(moments[2], 1e-30):
        return (SymmetryResult("D*h", 2, True) if has_inversion
                else SymmetryResult("C*v", 1, True))

    cands = _candidate_directions(x, axes)

    # --- operation census -------------------------------------------------
    # Each accepted-axis list is deduped by angular separation at the
    # SAME 1e-3 |dot| threshold perp_c2/sigma_v use below: the candidate
    # dedupe (1e-4, ~0.8 deg) is tighter than what the geometric
    # tolerance tol=0.05 accepts (~1 deg misalignment on typical radii),
    # so on slightly distorted structures one true axis could otherwise
    # count multiple times and inflate the cubic/icosahedral thresholds
    # toward a wrong (higher) group and wrong RRHO sigma.
    def _dedupe_axes(axes_list):
        kept = []
        for a in axes_list:
            if not any(abs(abs(np.dot(a, u)) - 1.0) < 1e-3 for u in kept):
                kept.append(a)
        return kept

    cn_axes = {order: [] for order in range(2, max_n_fold + 1)}
    for axis in cands:
        for order in range(2, max_n_fold + 1):
            r = _rotation_matrix(axis, 2 * np.pi / order)
            if _coincides(x, z, x @ r.T, tol):
                cn_axes[order].append(axis)
    cn_axes = {order: _dedupe_axes(v) for order, v in cn_axes.items()}
    mirrors = _dedupe_axes(
        [axis for axis in cands
         if _coincides(x, z, x @ _reflection_matrix(axis).T, tol)])

    def has_s2n(axis, order2n):
        s = (_rotation_matrix(axis, 2 * np.pi / order2n)
             @ _reflection_matrix(axis))
        return _coincides(x, z, x @ s.T, tol)

    # --- decision tree (the standard
    # group-theory flowchart) ---------------------------------------------
    # cubic/icosahedral: count distinct high-order axes
    if len(cn_axes[5]) >= 6 and len(cn_axes[3]) >= 10:
        pg = "Ih" if has_inversion else "I"
        return SymmetryResult(pg, _sigma_of(pg), False)
    if len(cn_axes[4]) >= 3 and len(cn_axes[3]) >= 4:
        pg = "Oh" if has_inversion else "O"
        return SymmetryResult(pg, _sigma_of(pg), False)
    if len(cn_axes[3]) >= 4 and len(cn_axes[2]) >= 3:
        if has_inversion:
            pg = "Th"
        elif len(mirrors) >= 6:
            pg = "Td"
        else:
            pg = "T"
        return SymmetryResult(pg, _sigma_of(pg), False)

    best_n = max((order for order in cn_axes if cn_axes[order]),
                 default=1)
    if best_n == 1:
        if mirrors:
            return SymmetryResult("Cs", 1, False)
        if has_inversion:
            return SymmetryResult("Ci", 1, False)
        # S2 = inversion (covered); no symmetry left
        return SymmetryResult("C1", 1, False)

    principal = cn_axes[best_n][0]

    def is_perp(v):
        return abs(np.dot(v, principal)) < 0.15

    def is_parallel(v):
        return abs(np.dot(v, principal)) > 1.0 - 1e-3

    # distinct perpendicular C2 axes
    perp_c2 = []
    for axis in cn_axes[2]:
        if is_perp(axis) and not any(
                abs(abs(np.dot(axis, u)) - 1.0) < 1e-3 for u in perp_c2):
            perp_c2.append(axis)
    has_perp_c2 = len(perp_c2) >= best_n

    has_sigma_h = any(is_parallel(m) for m in mirrors)
    # sigma_v / sigma_d: distinct mirror planes containing the principal
    # axis (normal perpendicular to it)
    sigma_v = []
    for m in mirrors:
        if is_perp(m) and not any(
                abs(abs(np.dot(m, u)) - 1.0) < 1e-3 for u in sigma_v):
            sigma_v.append(m)

    if has_perp_c2:
        if has_sigma_h:
            pg = f"D{best_n}h"
        elif len(sigma_v) >= best_n:
            pg = f"D{best_n}d"
        else:
            pg = f"D{best_n}"
    elif has_sigma_h:
        pg = f"C{best_n}h"
    elif len(sigma_v) >= best_n:
        pg = f"C{best_n}v"
    elif has_s2n(principal, 2 * best_n):
        pg = f"S{2 * best_n}"
    else:
        pg = f"C{best_n}"
    return SymmetryResult(pg, _sigma_of(pg), False)
