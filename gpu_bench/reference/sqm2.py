"""SQM2 energy, gradient and seminumerical Hessian in plain PyTorch, for
molecules of H to Ne (no d shells), in float64.

The benchmark's own statement of the method the program's SQM2 calculator
computes: an extended-Hueckel band energy over an STO-3G minimal basis with
a Fermi-smeared free energy, EEQ charges, a coordination-dependent
repulsion, charge-scaled D4 dispersion and the GFN0 short-range bond term.
It imports nothing of the program, and it reaches the band energy by
another route: the generalized eigenvalues of (H, S) through a Cholesky
factor of S (the same spectrum as Loewdin's S^-1/2 H S^-1/2), over the
basis functions that exist (hydrogen has no p shell here, where the program
carries decoupled placeholders), with `torch.linalg.eigvalsh`. The gradient
is autograd of the energy; the chemical potential is held fixed and the
grand-potential term -mu (N(mu) - N) added, so that dF/deps is the
occupation, as at fixed electron count.

Parameters are copied from the published tables the method names (STO-3G,
Hoffmann's VSIPs, Grimme's D2 C6 and D4 r4/r2, UFF radii, the GFN0 SRB
set) and frozen here.
"""

import math

import torch

HARTREE2EV = 27.211396127707
BOHR2ANGSTROM = 0.52917721067
ANGSTROM2BOHR = 1.0 / BOHR2ANGSTROM

# Z -> (principal shell, zeta, VSIP s eV, VSIP p eV or None, valence e-)
ELEMENTS = {
    1: (1, 1.240, -13.60, None, 1), 2: (1, 1.700, -23.40, None, 2),
    3: (2, 0.650, -5.40, -3.50, 1), 4: (2, 0.975, -10.00, -6.00, 2),
    5: (2, 1.300, -15.20, -8.50, 3), 6: (2, 1.625, -21.40, -11.40, 4),
    7: (2, 1.950, -26.00, -13.40, 5), 8: (2, 2.275, -32.30, -14.80, 6),
    9: (2, 2.600, -40.00, -18.10, 7), 10: (2, 2.925, -43.20, -20.00, 8),
}
# STO-3G exponents (zeta = 1) and contraction coefficients
STO3G = {
    1: ((2.227660584, 0.405771156, 0.109818),
        (0.154328967, 0.535328142, 0.444634542), None),
    2: ((0.994203122, 0.231031402, 0.0751386),
        (-0.09996723, 0.39951283, 0.70011547),
        (0.15591627, 0.60768372, 0.39195739)),
}
# EEQ electronegativity (eV), hardness (eV), charge radius (Bohr)
EEQ = {1: (7.18, 12.85, 1.4), 2: (12.3, 25.0, 1.3), 3: (3.01, 4.77, 2.6),
       4: (4.90, 8.90, 2.0), 5: (4.29, 8.02, 1.7), 6: (6.27, 10.00, 1.6),
       7: (7.30, 14.46, 1.5), 8: (7.54, 12.16, 1.4), 9: (10.41, 14.02, 1.3),
       10: (10.6, 21.0, 1.3)}
Z_EFF = {1: 1.6, 2: 1.2, 3: 1.0, 4: 1.8, 5: 2.4, 6: 4.0, 7: 3.0, 8: 3.4,
         9: 3.8, 10: 3.5}
CN0 = {1: 1.0, 2: 0.0, 3: 1.0, 4: 2.0, 5: 3.0, 6: 3.0, 7: 3.0, 8: 1.0,
       9: 1.0, 10: 0.0}
COV_RADIUS_ANG = {1: 0.32, 2: 0.46, 3: 1.33, 4: 1.02, 5: 0.85, 6: 0.75,
                  7: 0.71, 8: 0.63, 9: 0.64, 10: 0.67}
UFF_RADIUS_ANG = {1: 2.886, 2: 2.362, 3: 2.451, 4: 2.745, 5: 4.083,
                  6: 3.851, 7: 3.66, 8: 3.5, 9: 3.364, 10: 3.243}
D2_C6_JNM6 = {1: 0.14, 2: 0.08, 3: 1.61, 4: 1.61, 5: 3.13, 6: 1.75,
              7: 1.23, 8: 0.7, 9: 0.75, 10: 0.63}
D4_R4R2 = {1: 8.0589, 2: 3.4698, 3: 29.0974, 4: 14.8517, 5: 11.8799,
           6: 7.8715, 7: 5.5588, 8: 4.7566, 9: 3.8025, 10: 3.1036}
SRB_EN = {1: 2.30085633, 2: 2.78445145, 3: 1.52956084, 4: 1.51714704,
          5: 2.20568300, 6: 2.49640820, 7: 2.81007174, 8: 4.51078438,
          9: 4.67476223, 10: 3.29383610}
SRB_R0 = {1: 0.55682207, 2: 0.80966997, 3: 2.49092101, 4: 1.91705642,
          5: 1.35974851, 6: 0.98310699, 7: 0.98423007, 8: 0.76716063,
          9: 1.06139799, 10: 1.17736822}

K_SS, K_SP, K_SP_HEAVY, K_PP = 1.75, 2.4, 2.2, 2.2   # Wolfsberg-Helmholz
KT = 0.005                                            # Hartree
REP_K, REP_EXP, REP_R0, REP_R0_HEAVY, REP_CN = 0.4, 1.5, 0.42, 0.36, 0.1
REP_HH, REP_HH_GEM = 0.2, 0.003
D4_S6, D4_S8, D4_A1, D4_A2, D4_GA = 1.0, 1.03683, 0.4171, 4.5337, 3.0
SRB_K, SRB_ETA, SRB_GSCAL, SRB_C1, SRB_C2 = -0.013, 3.48, 0.51, -1.71, 2.11
HESSIAN_STEP = 1e-4                                   # Bohr


class Molecule:
    """Per-atom constants of one molecule on a device, float64."""

    def __init__(self, z, device, charge=0):
        z = [int(v) for v in z]
        bad = sorted({v for v in z if v not in ELEMENTS})
        if bad:
            raise ValueError(f"the plain SQM2 covers H to Ne, not Z={bad}")
        kw = dict(dtype=torch.float64, device=device)
        self.z, self.n = z, len(z)
        t = lambda vals: torch.tensor(vals, **kw)  # noqa: E731
        self.heavy = torch.tensor([v > 2 for v in z], device=device)
        shell = [ELEMENTS[v][0] for v in z]
        zeta = t([ELEMENTS[v][1] for v in z])
        base = t([STO3G[s][0] for s in shell])
        self.alpha = base * zeta[:, None] ** 2                  # (N, 3)
        self.c_s = t([STO3G[s][1] for s in shell])
        self.c_p = t([STO3G[2][2] for _ in z])                  # heavy only
        # basis functions: (atom, kind) with kind 0 = s, 1..3 = p x, y, z
        orbs = []
        for i, v in enumerate(z):
            orbs += [(i, 0)] + ([(i, 1), (i, 2), (i, 3)]
                                if ELEMENTS[v][3] is not None else [])
        self.orb_atom = torch.tensor([a for a, _ in orbs], device=device)
        self.orb_kind = torch.tensor([k for _, k in orbs], device=device)
        self.h_orb = t([(ELEMENTS[z[a]][2] if k == 0 else ELEMENTS[z[a]][3])
                        / HARTREE2EV for a, k in orbs])
        is_p = self.orb_kind > 0
        hv = self.heavy[self.orb_atom]
        sp = is_p[:, None] ^ is_p[None, :]
        k = lambda v: torch.tensor(v, **kw)  # noqa: E731
        self.k_wh = torch.where(
            sp, torch.where(hv[:, None] & hv[None, :], k(K_SP_HEAVY),
                            k(K_SP)),
            torch.where(is_p[:, None], k(K_PP), k(K_SS)))
        self.n_elec = float(sum(ELEMENTS[v][4] for v in z) - charge)
        self.e_ref = sum((min(ELEMENTS[v][4], 2) * ELEMENTS[v][2]
                          + max(ELEMENTS[v][4] - 2, 0)
                          * (ELEMENTS[v][3] or 0.0)) / HARTREE2EV for v in z)
        self.charge = float(charge)
        self.chi = t([EEQ[v][0] / HARTREE2EV for v in z])
        self.eta = t([EEQ[v][1] / HARTREE2EV for v in z])
        self.r_q = t([EEQ[v][2] for v in z])
        self.z_eff = t([Z_EFF[v] for v in z])
        self.cn0 = t([CN0[v] for v in z])
        self.rcov = t([COV_RADIUS_ANG[v] * ANGSTROM2BOHR for v in z])
        c6 = t([D2_C6_JNM6[v] / 6.02214076e23 / 4.3597447222071e-18
                / 0.052917721067 ** 6 for v in z])
        self.c6 = 2.0 * c6[:, None] * c6[None, :] / (c6[:, None] + c6[None, :])
        r4r2 = t([D4_R4R2[v] for v in z])
        self.c8 = 3.0 * self.c6 * torch.sqrt(r4r2[:, None] * r4r2[None, :])
        # the UFF radius in Bohr divided by the Bohr length once more: the
        # radius the method's D4 damping is defined with
        r_uff = t([UFF_RADIUS_ANG[v] * ANGSTROM2BOHR / BOHR2ANGSTROM
                   for v in z])
        self.r0_d4 = r_uff[:, None] + r_uff[None, :]
        self.srb_en = t([SRB_EN[v] for v in z])
        self.srb_r0 = t([SRB_R0[v] for v in z])
        iu, ju = torch.triu_indices(self.n, self.n, 1, device=device)
        self.iu, self.ju = iu, ju
        zt = torch.tensor(z, device=device)
        self.hh = (zt[iu] == 1) & (zt[ju] == 1)
        self.heavy_pair = self.heavy[iu] & self.heavy[ju]


def model(config, device):
    """The Molecule of a benchmark configuration (`molecule.z`,
    `calculator.charge`)."""
    return Molecule(config["molecule"]["z"], device,
                    config["calculator"].get("charge", 0))


def _overlap(x, mol):
    """(B, M, M) overlap of the basis functions that exist, same-atom
    blocks the identity."""
    a = mol.alpha                                           # (N, 3)
    r_ij = x[:, :, None, :] - x[:, None, :, :]              # A - B
    r2 = (r_ij * r_ij).sum(-1)
    ai, aj = a[:, None, :, None], a[None, :, None, :]       # (N, N, 3, 3)
    p = ai + aj
    k = (math.pi / p) ** 1.5 * torch.exp(-(ai * aj / p) * r2[..., None, None])
    n_s = (2.0 * a / math.pi) ** 0.75
    n_p = n_s * 2.0 * torch.sqrt(a)
    ws = mol.c_s * n_s
    wp = mol.c_p * n_p
    pa = -(aj / p)[..., None] * r_ij[:, :, :, None, None, :]   # P - A
    pb = (ai / p)[..., None] * r_ij[:, :, :, None, None, :]    # P - B

    def contract(wi, wj, f):
        return (wi[:, None, :, None] * wj[None, :, None, :] * k * f).sum(
            (-2, -1))

    ss = contract(ws, ws, 1.0)
    sp = torch.stack([contract(ws, wp, pb[..., c]) for c in range(3)], -1)
    ps = torch.stack([contract(wp, ws, pa[..., c]) for c in range(3)], -1)
    pp = torch.stack([torch.stack([
        contract(wp, wp, pa[..., c] * pb[..., d] + (c == d) / (2.0 * p))
        for d in range(3)], -1) for c in range(3)], -2)
    blocks = torch.cat([torch.cat([ss[..., None, None], sp[..., None, :]], -1),
                        torch.cat([ps[..., :, None], pp], -1)], -2)
    oa, ok = mol.orb_atom, mol.orb_kind
    s = blocks[:, oa[:, None], oa[None, :], ok[:, None], ok[None, :]]
    same = oa[:, None] == oa[None, :]
    eye = torch.eye(len(oa), dtype=x.dtype, device=x.device)
    return torch.where(same, eye, s)


def _mu(w, n_elec, kt, iters=200):
    """Chemical potential (B,) at which the Fermi occupations of w hold
    n_elec electrons, by bisection to the last bit."""
    lo = w.amin(-1) - 1.0
    hi = w.amax(-1) + 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        few = (2.0 * torch.sigmoid(-(w - mid[:, None]) / kt)).sum(-1) < n_elec
        lo, hi = torch.where(few, mid, lo), torch.where(few, hi, mid)
    return 0.5 * (lo + hi)


def band_free_energy(h, s, n_elec, kt=KT):
    """Mermin free energy (B,) of the generalized problem H c = e S c."""
    m = s.shape[-1]
    eye = torch.eye(m, dtype=s.dtype, device=s.device)
    chol = torch.linalg.cholesky(s + 1e-10 * eye)
    t = torch.linalg.solve_triangular(chol, h, upper=False)
    hp = torch.linalg.solve_triangular(chol, t.mT, upper=False)
    w = torch.linalg.eigvalsh(0.5 * (hp + hp.mT))
    mu = _mu(w.detach(), n_elec, kt)
    xs = (w - mu[:, None]) / kt
    f = torch.sigmoid(-xs)
    entropy = 2.0 * (f * torch.nn.functional.softplus(xs)
                     + (1.0 - f) * torch.nn.functional.softplus(-xs)).sum(-1)
    occ = 2.0 * f
    return (occ * w).sum(-1) - kt * entropy - mu * (occ.sum(-1) - n_elec)


def energy(x, mol):
    """SQM2 energies (B,) of geometries x (B, N, 3) in Bohr."""
    b, n, _ = x.shape
    iu, ju = mol.iu, mol.ju
    d = x[:, iu] - x[:, ju]
    r = torch.sqrt((d * d).sum(-1))                      # (B, P), i < j

    # EEQ charges and energy
    g2 = mol.r_q[iu] ** 2 + mol.r_q[ju] ** 2
    a_off = 1.0 / torch.sqrt(r * r + g2)
    a = torch.diag_embed((mol.eta + math.sqrt(2.0 / math.pi) / mol.r_q)
                         .expand(b, n))
    a = a.index_put((torch.arange(b, device=x.device)[:, None], iu, ju),
                    a_off).index_put(
        (torch.arange(b, device=x.device)[:, None], ju, iu), a_off)
    border = torch.zeros(b, n + 1, n + 1, dtype=x.dtype, device=x.device)
    border[:, :n, :n] = a
    border[:, :n, n] = 1.0
    border[:, n, :n] = 1.0
    rhs = torch.cat([-mol.chi.expand(b, n),
                     torch.full((b, 1), mol.charge, dtype=x.dtype,
                                device=x.device)], -1)
    q = torch.linalg.solve(border, rhs)[:, :n]
    e_eeq = (mol.chi * q).sum(-1) + 0.5 * (q * (a @ q[..., None])[..., 0]).sum(
        -1)

    # extended-Hueckel band energy
    s = _overlap(x, mol)
    h_o = mol.h_orb
    hmat = 0.5 * mol.k_wh * (h_o[:, None] + h_o[None, :]) * s
    hmat = torch.where(torch.eye(len(h_o), dtype=torch.bool, device=x.device),
                       torch.diag(h_o), hmat)
    e_eht = band_free_energy(hmat, s, mol.n_elec) - mol.e_ref

    # repulsion, with a wall radius scaled by the D3 coordination number
    rc = mol.rcov[iu] + mol.rcov[ju]
    term = torch.clamp(-16.0 * (4.0 / 3.0 * rc / r - 1.0), -100.0, 100.0)
    f_cn = 1.0 / (1.0 + torch.exp(term))
    cn = torch.zeros(b, n, dtype=x.dtype, device=x.device)
    cn = cn.index_add(1, iu, f_cn).index_add(1, ju, f_cn)
    dev_cn = torch.clamp(mol.cn0 - cn, -1.5, 1.0)
    scale = torch.clamp(1.0 + REP_CN * 0.5 * (dev_cn[:, iu] + dev_cn[:, ju]),
                        0.7, 1.4)
    r0 = torch.where(mol.heavy_pair, REP_R0_HEAVY * rc * scale, REP_R0 * rc)
    e_rep = (REP_K * mol.z_eff[iu] * mol.z_eff[ju] / r
             * torch.exp(-(r / r0) ** REP_EXP)
             + torch.where(mol.hh, REP_HH / r * torch.exp(-(r / 1.1) ** 2)
                           + REP_HH_GEM * torch.exp(-((r - 2.8) / 0.45) ** 2),
                           0.0)).sum(-1)

    # D4 two-body dispersion scaled by the EEQ charges
    qs = torch.exp(-D4_GA * (q[:, iu] ** 2 + q[:, ju] ** 2))
    bj = (mol.r0_d4[iu, ju] + D4_A1) * D4_A2
    e_disp = -(qs * (D4_S6 * mol.c6[iu, ju] / (r ** 6 + bj ** 6)
                     + D4_S8 * mol.c8[iu, ju] / (r ** 8 + bj ** 8))).sum(-1)

    # GFN0 short-range bond correction
    den = (mol.srb_en[iu] - mol.srb_en[ju]).abs()
    r_cov = ((mol.srb_r0[iu] + mol.srb_r0[ju])
             * (1.0 - SRB_C1 * den - SRB_C2 * den ** 2))
    e_srb = (SRB_K * torch.exp(-SRB_ETA * (1.0 + SRB_GSCAL * den ** 2)
                               * (r - r_cov) ** 2)).sum(-1)
    return e_eht + e_eeq + e_rep + e_disp + e_srb


def energy_and_gradient(x, mol, block=256):
    """(E (B,), dE/dx (B, N, 3)) of x (B, N, 3), `block` rows at a time."""
    es, gs = [], []
    for lo in range(0, x.shape[0], block):
        with torch.enable_grad():
            xb = x[lo:lo + block].detach().to(torch.float64).requires_grad_()
            e = energy(xb, mol)
            (g,) = torch.autograd.grad(e.sum(), xb)
        es.append(e.detach())
        gs.append(g)
    return torch.cat(es), torch.cat(gs)


def hessian(x, mol, block=256):
    """(B, 3N, 3N) central differences of the gradient, step HESSIAN_STEP,
    symmetrized."""
    b, n, _ = x.shape
    n3 = 3 * n
    step = torch.eye(n3, dtype=torch.float64, device=x.device) * HESSIAN_STEP
    flat = x.to(torch.float64).reshape(b, 1, n3)
    disp = torch.cat([flat + step, flat - step], 1).reshape(-1, n, 3)
    g = energy_and_gradient(disp, mol, block)[1].reshape(b, 2, n3, n3)
    h = (g[:, 0] - g[:, 1]) / (2.0 * HESSIAN_STEP)
    return 0.5 * (h + h.mT)
