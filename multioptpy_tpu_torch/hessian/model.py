"""Model (guess) Hessians: Lindh, Lindh 2007, Fischer, Schlegel, Swart,
GFN0/GFN-FF-flavoured, Morse, with dispersion, short-range, TS and damped
variants.

Counterpart of `multioptpy_tpu/hessian/model.py`. Each bonded model is a
diagonal force-constant vector k over internal primitives, and the
Cartesian guess is one contraction H_x = B^T diag(k) B with the autodiff
Wilson matrix:

  lindh      Lindh, CPL 241 (1995) 423: k0 = 0.45/0.15/0.005 times
             products of rho = exp(alpha (R_ref^2 - r^2))
  lindh2007  all-pair screening with gated D4 long-range terms
  fischer    Fischer & Almlof, JPC 96 (1992) 9768
  schlegel   Schlegel, TCA 66 (1984) 333
  swart      Swart & Bickelhaupt, IJQC 106 (2006) 2536 (Lindh-like
             torsions)
  gfn0/gfnff GFN0-xTB-flavoured stretches typed by compression, bends,
             weak torsions; gfnff adds electronegativity strengthening
  morse      all-pairs Morse oscillators, exact autodiff Hessian

A kind name may carry `_d2`/`_d3`/`_d4` (or `d2`...) for the exact
dispersion Hessian, `old` (static D3 C6 for fischer), `_sr` (short-range
erf correction), `_ts` (Householder-reflected TS guess) and `_raw`; the
lindh2007d{2,3,4} kinds apply the reference's gradient-damped transform
V diag(|lambda| 0.1 exp(-|g|^2)) V^T unless `_raw`. Everything runs on
batched coordinates (B, N, 3) -> (B, 3N, 3N) for static primitive sets.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.coords.internals import (InternalCoordinates,
                                                   detect_primitives)
from multioptpy_tpu_torch.geometry import (bond_connectivity,
                                           project_hessian_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.hessian import dispersion
from multioptpy_tpu_torch.ops.eigh64 import eigh_deflated
from multioptpy_tpu_torch.periodic import COVALENT_RADII_1, PAULING_EN

MODEL_HESSIAN_KINDS = ("lindh", "lindh2007", "fischer", "schlegel", "swart",
                       "morse", "gfn0", "gfnff")

# period index: 0 = H/He, 1 = Li..Ne, 2 = rest
_LINDH_ALPHA = np.array([[1.0000, 0.3949, 0.3949],
                         [0.3949, 0.2800, 0.2800],
                         [0.3949, 0.2800, 0.2800]])
# Lindh 2007 groups H | He..F | rest: screening exponents and d-table
_ALPHA_2007 = np.array([[1.0000, 0.3949, 0.3949],
                        [0.3949, 0.2800, 0.1200],
                        [0.3949, 0.1200, 0.0600]])
_D_2007 = np.array([[0.0, 3.6, 3.6],
                    [3.6, 5.3, 5.3],
                    [3.6, 5.3, 5.3]])
# Schlegel B parameters by period pair (Bohr)
_SCHLEGEL_B = np.array([
    [0.2573, 0.3401, 0.6937, 0.7126, 0.8335, 0.9491, 0.9491],
    [0.3401, 0.9652, 1.2843, 1.4725, 1.6549, 1.7190, 1.7190],
    [0.6937, 1.2843, 1.6925, 1.8238, 2.1164, 2.3185, 2.3185],
    [0.7126, 1.4725, 1.8238, 2.0203, 2.2137, 2.5206, 2.5206],
    [0.8335, 1.6549, 2.1164, 2.2137, 2.3718, 2.5110, 2.5110],
    [0.9491, 1.7190, 2.3185, 2.5206, 2.5110, 2.5110, 2.5110],
    [0.9491, 1.7190, 2.3185, 2.5206, 2.5110, 2.5110, 2.5110]])
_PERIOD_EDGES = np.array([2, 10, 18, 36, 54, 86, 118])

# GFN0-xTB atomic radii (Bohr) and Mulliken electronegativities, Z=1..54;
# heavier elements take 1.0 / 2.0
_GFN0_RAD = np.full(119, 1.0)
_GFN0_RAD[1:55] = [
    0.75, 0.75, 1.23, 1.01, 0.90, 0.85, 0.84, 0.83, 0.83, 0.75,
    1.60, 1.40, 1.25, 1.14, 1.09, 1.04, 1.00, 0.75, 1.90, 1.71,
    1.48, 1.36, 1.34, 1.22, 1.19, 1.17, 1.16, 1.15, 1.14, 1.23,
    1.25, 1.21, 1.16, 1.14, 1.12, 0.75, 2.06, 1.85, 1.61, 1.48,
    1.37, 1.31, 1.23, 1.24, 1.24, 1.19, 1.26, 1.36, 1.47, 1.40,
    1.39, 1.35, 1.33, 0.75,
]
_GFN0_EN = np.full(119, 2.0)
_GFN0_EN[1:55] = [
    2.20, 0.00, 0.97, 1.47, 2.01, 2.50, 3.07, 3.50, 4.10, 0.00,
    1.01, 1.23, 1.47, 1.74, 2.06, 2.44, 2.83, 0.00, 0.91, 1.04,
    1.20, 1.32, 1.45, 1.56, 1.60, 1.64, 1.70, 1.75, 1.75, 1.66,
    1.82, 2.02, 2.20, 2.48, 2.74, 0.00, 0.89, 0.99, 1.11, 1.22,
    1.23, 1.30, 1.36, 1.42, 1.45, 1.35, 1.42, 1.46, 1.49, 1.72,
    1.82, 2.01, 2.21, 0.00,
]


def _group3(z):
    z = np.asarray(z)
    return np.where(z < 2, 0, np.where(z < 10, 1, 2))


def _period3(z):
    """0: H/He, 1: second period, 2: beyond (Lindh classes)."""
    z = np.asarray(z)
    return np.where(z <= 2, 0, np.where(z <= 10, 1, 2))


def _period7(z):
    return np.searchsorted(_PERIOD_EDGES, np.asarray(z), side="left")


def _dist(coords, i, j):
    d = coords[:, np.asarray(i)] - coords[:, np.asarray(j)]
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def _bond_count(bonds, n_atoms):
    cnt = np.zeros(n_atoms, dtype=np.int64)
    for i, j in np.asarray(bonds).reshape(-1, 2):
        cnt[i] += 1
        cnt[j] += 1
    return cnt


def _lindh2007_constants(coords, z, bonds, angles, torsions, t):
    """Lindh 2007: kr/kf/kt = 0.45/0.10/0.0025, the D4 pair force constant
    joining a pair's screening only beyond twice its covalent length."""
    rcov = np.asarray(COVALENT_RADII_1)[z]
    g3 = _group3(z)
    kr, kf, kt, kd = 0.45, 0.10, 0.0025, 0.05
    charges = dispersion.d4_charges(coords, z)
    c6m, c8m, r0m = dispersion.d4_pair_tables(z, dtype=np.float64)
    parts = []

    def g_pair(i, j):
        """exp screening + gated D4 term + d-table factor for pairs (i, j)."""
        i = np.asarray(i)
        j = np.asarray(j)
        r = _dist(coords, i, j)
        rc = t(rcov[i] + rcov[j])
        g = torch.exp(t(_ALPHA_2007[g3[i], g3[j]]) * (rc ** 2 - r * r))
        qs = torch.exp(-3.0 * (charges[:, i] ** 2 + charges[:, j] ** 2))
        d4 = dispersion.d4_pair_force_const(r, t(c6m[i, j]), t(c8m[i, j]),
                                            t(r0m[i, j]), qs)
        return g, torch.where(r > 2.0 * rc, d4, 0.0), t(_D_2007[g3[i], g3[j]])

    if len(bonds):
        g, d4, _ = g_pair(bonds[:, 0], bonds[:, 1])
        parts.append(kr * g + kd * d4)
    if len(angles):
        g1, d41, d01 = g_pair(angles[:, 1], angles[:, 0])
        g2, d42, d02 = g_pair(angles[:, 1], angles[:, 2])
        half = 0.5 * kd / kr
        parts.append(kf * (g1 + 0.5 * kd * d41 + half * d01)
                     * (g2 + 0.5 * kd * d42 + half * d02))
    if len(torsions):
        # the reference multiplies each leg's screening by the d-table
        # factor here (the angle term adds it)
        half = 0.5 * kd / kr
        legs = []
        for a, b in ((0, 1), (1, 2), (2, 3)):
            g, d4, d0 = g_pair(torsions[:, a], torsions[:, b])
            legs.append((g + 0.5 * kd * d4) * half * d0)
        parts.append(kt * legs[0] * legs[1] * legs[2])
    return parts


def _primitive_constants(kind, coords, z, bonds, angles, torsions, n_atoms):
    """Per-primitive diagonal force constants (B, M) of a bonded model."""
    z = np.asarray(z)
    kind_t = dict(dtype=coords.dtype, device=coords.device)

    def t(x):
        return torch.as_tensor(np.asarray(x), **kind_t)

    rcov = np.asarray(COVALENT_RADII_1)[z]
    parts = []
    if kind == "lindh":
        a3 = _period3(z)

        def rho(i, j):
            r = _dist(coords, i, j)
            return torch.exp(t(_LINDH_ALPHA[a3[i], a3[j]])
                             * (t(rcov[i] + rcov[j]) ** 2 - r * r))

        if len(bonds):
            parts.append(0.45 * rho(bonds[:, 0], bonds[:, 1]))
        if len(angles):
            parts.append(0.15 * rho(angles[:, 0], angles[:, 1])
                         * rho(angles[:, 1], angles[:, 2]))
        if len(torsions):
            parts.append(0.005 * rho(torsions[:, 0], torsions[:, 1])
                         * rho(torsions[:, 1], torsions[:, 2])
                         * rho(torsions[:, 2], torsions[:, 3]))
    elif kind == "lindh2007":
        parts = _lindh2007_constants(coords, z, bonds, angles, torsions, t)
    elif kind == "fischer":
        if len(bonds):
            r = _dist(coords, bonds[:, 0], bonds[:, 1])
            rc = rcov[bonds[:, 0]] + rcov[bonds[:, 1]]
            parts.append(0.3601 * torch.exp(-1.944 * (r - t(rc))))
        if len(angles):
            r1 = _dist(coords, angles[:, 0], angles[:, 1])
            r2 = _dist(coords, angles[:, 1], angles[:, 2])
            rc1 = rcov[angles[:, 0]] + rcov[angles[:, 1]]
            rc2 = rcov[angles[:, 1]] + rcov[angles[:, 2]]
            parts.append(0.089 + 0.11 * t(rc1 * rc2) ** 0.42
                         * torch.exp(-0.44 * (r1 + r2 - t(rc1 + rc2))))
        if len(torsions):
            r = _dist(coords, torsions[:, 1], torsions[:, 2])
            rc = t(rcov[torsions[:, 1]] + rcov[torsions[:, 2]])
            cnt = _bond_count(bonds, n_atoms)
            bond_sum = np.maximum(cnt[torsions[:, 1]] + cnt[torsions[:, 2]]
                                  - 2, 0)
            val = r * rc
            parts.append(0.0015 + 14.0 * t(bond_sum) ** 0.57 / val ** 4.0
                         * torch.exp(-2.85 * (r - rc)))
    elif kind == "schlegel":
        p7 = np.minimum(_period7(z), 6)
        if len(bonds):
            r = _dist(coords, bonds[:, 0], bonds[:, 1])
            b = t(_SCHLEGEL_B[p7[bonds[:, 0]], p7[bonds[:, 1]]])
            # guard near-singular short bonds
            parts.append(1.734 / torch.clamp(r - b, min=0.1) ** 3)
        if len(angles):
            term_h = (z[angles[:, 0]] == 1) | (z[angles[:, 2]] == 1)
            parts.append(t(np.where(term_h, 0.160, 0.250))
                         * coords.new_ones((coords.shape[0], len(angles))))
        if len(torsions):
            r = _dist(coords, torsions[:, 1], torsions[:, 2])
            rc = t(rcov[torsions[:, 1]] + rcov[torsions[:, 2]])
            parts.append(torch.clamp(0.0023 - 0.07 * (r - rc), min=1e-4))
    elif kind == "swart":
        f = 0.12

        def screen(i, j):
            return torch.exp(1.0 - _dist(coords, i, j) / t(rcov[i] + rcov[j]))

        if len(bonds):
            parts.append(0.35 * screen(bonds[:, 0], bonds[:, 1]) ** 3)
        if len(angles):
            s2 = (screen(angles[:, 0], angles[:, 1])
                  * screen(angles[:, 1], angles[:, 2]))
            v1 = coords[:, angles[:, 0]] - coords[:, angles[:, 1]]
            v2 = coords[:, angles[:, 2]] - coords[:, angles[:, 1]]
            cross = torch.linalg.cross(v1, v2)
            sin_t = torch.sqrt((cross * cross).sum(-1) + 1e-14) / (
                torch.sqrt((v1 * v1).sum(-1) * (v2 * v2).sum(-1)) + 1e-14)
            parts.append(0.075 * s2 ** 2 * (f + (1 - f) * sin_t) ** 2)
        if len(torsions):
            parts.append(0.005 * screen(torsions[:, 0], torsions[:, 1])
                         * screen(torsions[:, 1], torsions[:, 2])
                         * screen(torsions[:, 2], torsions[:, 3]))
    elif kind in ("gfn0", "gfnff"):
        rad = _GFN0_RAD[z]
        en = _GFN0_EN[z]
        if len(bonds):
            bi, bj = bonds[:, 0], bonds[:, 1]
            ratio = _dist(coords, bi, bj) / t(rad[bi] + rad[bj])
            factor = torch.where(ratio < 0.82, 2.0,
                                 torch.where(ratio < 0.92, 1.5,
                                             torch.ones_like(ratio)))
            k_b = 0.35 * factor
            if kind == "gfnff":
                k_b = k_b * (1.0 + 0.1 * t(np.abs(en[bi] - en[bj])))
            # damp stretched/broken bonds smoothly
            parts.append(k_b * torch.exp(-2.0 * torch.clamp(ratio - 1.3,
                                                            min=0.0)))
        if len(angles):
            a0, a1, a2 = angles[:, 0], angles[:, 1], angles[:, 2]
            s = (torch.exp(-torch.clamp(_dist(coords, a0, a1)
                                        / t(rad[a0] + rad[a1]) - 1.3,
                                        min=0.0))
                 * torch.exp(-torch.clamp(_dist(coords, a1, a2)
                                          / t(rad[a1] + rad[a2]) - 1.3,
                                          min=0.0)))
            parts.append(0.07 * s)
        if len(torsions):
            parts.append(coords.new_full((coords.shape[0], len(torsions)),
                                         0.005))
    else:
        raise ValueError(f"unknown model hessian '{kind}'")
    if not parts:
        return coords.new_zeros((coords.shape[0], 0))
    return torch.cat(parts, dim=-1)


def lindh2007_primitives(coords, z, rho_cutoff=1e-6):
    """Tuple lists of the Lindh-2007 all-pairs model for one structure
    (N, 3): every pair is a 'bond' primitive, triples are kept when both
    legs' screenings survive `rho_cutoff`, torsions come from ordinary
    connectivity. Host-side numpy."""
    coords = np.asarray(coords)
    z = np.asarray(z)
    n = len(z)
    rcov = np.asarray(COVALENT_RADII_1)[z]
    g3 = _group3(z)
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    rc = rcov[:, None] + rcov[None, :]
    rho = np.exp(_ALPHA_2007[g3[:, None], g3[None, :]] * (rc ** 2 - d ** 2))
    bonds = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     dtype=np.int32).reshape(-1, 2)
    angles = [(j, i, k)
              for i in range(n) for j in range(n) for k in range(n)
              if j < k and i != j and i != k
              and rho[i, j] * rho[i, k] > rho_cutoff]
    angles = np.asarray(angles, dtype=np.int32).reshape(-1, 3)
    _, _, torsions = detect_primitives(coords, z)
    return bonds, angles, np.asarray(torsions, np.int32).reshape(-1, 4)


def _parse_kind(kind):
    """kind -> (base, dispersion, d3_dynamic, add_sr, make_ts, damp), in the
    reference's order of suffix stripping."""
    base = kind.lower()
    damp_raw = base.endswith("_raw")
    if damp_raw:
        base = base[: -len("_raw")]
    if base != "lindh2007" and not base.startswith("lindh2007d"):
        # "fischerd3"-style names fold to their parent; lindh2007 is a
        # distinct kind
        base = base.replace("2007", "")
    make_ts = base.endswith("_ts")
    if make_ts:
        base = base[: -len("_ts")]
    add_sr = base.endswith("_sr")
    if add_sr:
        base = base[: -len("_sr")]
    # fischerd3 scales C6 by coordination number; fischerd3old and the
    # lindh2007d3 family use the static form
    d3_dynamic = base.startswith("fischer") and not base.endswith("old")
    if base.endswith("old"):
        base = base[: -len("old")]
    damp = (base.startswith("lindh2007") and base != "lindh2007"
            and not damp_raw)
    disp = None
    for suffix in ("_d2", "_d3", "_d4", "d2", "d3", "d4"):
        if base.endswith(suffix):
            disp = "d" + suffix[-1]
            base = base[: -len(suffix)]
            break
    return base, disp, d3_dynamic, add_sr, make_ts, damp


def make_model_hessian_fn(z, bonds, angles, torsions, kind="lindh",
                          project=True):
    """`fn(coords (B,N,3), gradient (B,N,3) or None) -> (B,3N,3N)` for
    static primitives and a kind name with its suffixes (module
    docstring)."""
    z = np.asarray(z)
    n_atoms = len(z)
    base, disp, d3_dynamic, add_sr, make_ts, damp = _parse_kind(kind)
    ic = InternalCoordinates(bonds, angles, torsions, n_atoms)

    def fn(coords, gradient=None):
        if base == "morse":
            h = morse_hessian(coords, z)
        else:
            k = _primitive_constants(base, coords, z, ic.bonds, ic.angles,
                                     ic.torsions, n_atoms)
            b = ic.b_matrix(coords)
            h = (b.mT * k[:, None, :]) @ b
        if disp == "d2":
            h = h + dispersion.d2_hessian(coords, z)
        elif disp == "d3":
            h = h + dispersion.d3_hessian(coords, z, dynamic_cn=d3_dynamic)
        elif disp == "d4":
            h = h + dispersion.d4_hessian(coords, z)
        if add_sr:
            h = h + short_range_hessian(coords, z, bonds=ic.bonds)
        h = 0.5 * (h + h.mT)
        proj = None
        if project:
            proj = tr_rot_projector(coords)
            h = project_hessian_tr_rot(h, coords)
        if damp:
            # V diag(|lambda| 0.1 exp(-|g|^2)) V^T of each member
            ng2 = ((gradient ** 2).sum((-2, -1)) if gradient is not None
                   else coords.new_zeros(coords.shape[0]))
            w, v = (eigh_deflated(h, proj) if proj is not None
                    else torch.linalg.eigh(h))
            scale = w.abs() * 0.1 * torch.exp(-ng2)[:, None]
            h = (v * scale[:, None, :]) @ v.mT
        if make_ts:
            h = ts_model_hessian(h, projector=proj)
        return h

    return fn


def model_hessian(coords, z, kind="lindh", project=True, primitives=None,
                  gradient=None):
    """One-shot model Hessians (B, 3N, 3N) of coords (B, N, 3); unless
    `primitives` are given they are detected host-side for each member
    (the Lindh 2007 all-pairs set for lindh2007 kinds)."""
    if primitives is not None:
        fn = make_model_hessian_fn(z, *primitives, kind, project)
        return fn(coords, gradient)
    out = []
    for i in range(coords.shape[0]):
        c_np = coords[i].detach().cpu().numpy()
        prims = (lindh2007_primitives(c_np, z)
                 if kind.lower().startswith("lindh2007")
                 else detect_primitives(c_np, z))
        fn = make_model_hessian_fn(z, *prims, kind, project)
        out.append(fn(coords[i:i + 1], None if gradient is None
                      else gradient[i:i + 1]))
    return torch.cat(out)


def _pair_hessian(pair_energy, coords):
    """(B, 3N, 3N) autodiff Hessians of sum_pairs pair_energy(r (N,N))."""
    b, n, _ = coords.shape

    def energy(x_flat):
        x = x_flat.reshape(n, 3)
        diff = x[:, None, :] - x[None, :, :]
        return pair_energy(torch.sqrt((diff * diff).sum(-1) + 1e-12))

    return torch.func.vmap(torch.func.hessian(energy))(
        coords.detach().reshape(b, 3 * n))


def morse_hessian(coords, z, de=0.10, a=0.20):
    """All-pairs Morse model Hessians: each pair a Morse oscillator
    De (1 - exp(-a (r - r_eq)))^2 with r_eq the covalent radii sum; exact
    Cartesian second derivatives by autodiff."""
    z = np.asarray(z)
    n = coords.shape[-2]
    kind = dict(dtype=coords.dtype, device=coords.device)
    rc = COVALENT_RADII_1[z]
    r_eq = torch.as_tensor(rc[:, None] + rc[None, :], **kind)
    mask = torch.ones(n, n, dtype=torch.bool, device=coords.device).triu(1)

    def pair_energy(r):
        v = de * (1.0 - torch.exp(-a * (r - r_eq))) ** 2
        return torch.where(mask, v, 0.0).sum()

    return _pair_hessian(pair_energy, coords)


def ts_model_hessian(h, thresh=1e-8, projector=None):
    """One negative direction injected into positive-definite model
    Hessians (B, D, D) by the Householder reflection along the lowest
    non-singular mode, H_ts = sym((I - 2 v v^T) H); members that already
    have a negative eigenvalue pass unchanged. Pass `projector` when `h` is
    TR/rot-projected (deflated eigh)."""
    hs = 0.5 * (h + h.mT)
    w, v = (eigh_deflated(hs, projector) if projector is not None
            else torch.linalg.eigh(hs))
    has_neg = (w < -thresh).any(-1)
    idx = torch.argmax((w.abs() > thresh).to(torch.int8), dim=-1)
    vec = torch.gather(v, -1, idx[:, None, None].expand(-1, v.shape[-2], 1))
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    h_ts = (eye - 2.0 * vec @ vec.mT) @ h
    h_ts = 0.5 * (h_ts + h_ts.mT)
    return torch.where(has_neg[:, None, None], h, h_ts)


def short_range_hessian(coords, z, bonds=None, omega=0.2, cx_sr=0.78,
                        scale=0.5, cutoff=15.0):
    """Short-range erf-screened Coulomb correction for non-bonded pairs:
    exact autodiff Hessians of scale cx_sr sum_pairs q_i q_j
    (1 - erf(omega r))/r with the Pauling-EN charge estimate
    q_i = 0.2 (mean(EN) - EN_i); bonded pairs (`bonds`, else detected on
    the first member) and pairs beyond `cutoff` Bohr are excluded."""
    z = np.asarray(z)
    n = coords.shape[-2]
    kind = dict(dtype=coords.dtype, device=coords.device)
    en = PAULING_EN[z]
    q = 0.2 * (en.mean() - en)
    qq = torch.as_tensor(np.outer(q, q), **kind)
    if bonds is None:
        conn = bond_connectivity(coords[0].detach(), z).cpu().numpy()
    else:
        conn = np.zeros((n, n), dtype=bool)
        for i, j in np.asarray(bonds).reshape(-1, 2):
            conn[i, j] = conn[j, i] = True
    pair_mask = torch.as_tensor(np.triu(np.ones((n, n), dtype=bool), k=1)
                                & ~conn, device=coords.device)

    def pair_energy(r):
        v = qq * (1.0 - torch.special.erf(omega * r)) / r
        return scale * cx_sr * torch.where(pair_mask & (r < cutoff), v,
                                           0.0).sum()

    return _pair_hessian(pair_energy, coords)


def smooth_eigenvalues(h, alpha=0.1):
    """Compress |eigenvalues| >= 1 of symmetric (B, D, D) toward
    2 - 1/|e|^alpha."""
    w, v = torch.linalg.eigh(h)
    w_s = torch.where(w.abs() >= 1.0,
                      torch.sign(w) * (2.0 - 1.0 / w.abs() ** alpha), w)
    return (v * w_s[:, None, :]) @ v.mT
