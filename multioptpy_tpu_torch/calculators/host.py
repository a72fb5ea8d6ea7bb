"""Host-side QM backends: the library call runs on the host, its result
comes back as tensors on the calculator's device.

Counterpart of `multioptpy_tpu/calculators/host.py`. Each bridge wraps one
library (tblite, dxtb, PySCF, Psi4, ASE and the codes it drives, GPAW,
Quantum ESPRESSO) behind `energy_and_gradient(coords (B, N, 3), z)`: the
batch goes to the host as numpy (Bohr), its members fan out over a thread
pool (the libraries release the GIL in their compute kernels), and the
energies and gradients (Hartree, Hartree/Bohr) come back as tensors on
the device and in the dtype of the coordinates. That round trip is the
nature of these backends. Hessians are central differences of the
gradient (one batch of 6N displaced structures).

Every bridge is import-gated: constructing one raises ImportError naming
its library when the library is absent.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   register_calculator)
from multioptpy_tpu_torch.periodic import z_to_symbol
from multioptpy_tpu_torch.units import ANGSTROM2BOHR, BOHR2ANGSTROM


class HostCalculator(Calculator):
    """Base of the backends whose energy and gradient are computed on the
    host. Subclasses implement `_host_energy_gradient(coords_bohr np,
    z np) -> (float, (N,3) np)`; a batch fans out across a thread pool."""

    on_device = False
    _pool = None
    max_workers = 8

    def _host_energy_gradient(self, coords, z):
        raise NotImplementedError

    def _host_batched(self, coords_b, z):
        coords_b = np.asarray(coords_b, dtype=np.float64)
        if coords_b.ndim == 2:
            e, g = self._host_energy_gradient(coords_b, np.asarray(z))
            return np.float64(e), np.asarray(g, dtype=np.float64)
        if HostCalculator._pool is None:
            HostCalculator._pool = ThreadPoolExecutor(self.max_workers)
        futs = [HostCalculator._pool.submit(self._host_energy_gradient, c,
                                            np.asarray(z))
                for c in coords_b]
        results = [f.result() for f in futs]
        e = np.array([r[0] for r in results], dtype=np.float64)
        g = np.stack([r[1] for r in results]).astype(np.float64)
        return e, g

    def energy_and_gradient(self, coords, z):
        """(B, N, 3) -> (E (B,), g (B, N, 3)) on coords' device."""
        e, g = self._host_batched(coords.detach().cpu().numpy(), z)
        opts = dict(dtype=coords.dtype, device=coords.device)
        return torch.as_tensor(e, **opts), torch.as_tensor(g, **opts)

    def energy(self, coords, z):
        return self.energy_and_gradient(coords, z)[0]

    def hessian(self, coords, z):
        return self.numerical_hessian(coords, z)


@register_calculator("tblite")
class TBLite(HostCalculator):
    """GFN1-/GFN2-xTB through tblite's python API.

    options: method ("GFN2-xTB"/"GFN1-xTB"); solvation=(model, solvent),
    model "cpcm" or "alpb", forwarded to tblite's Calculator.add."""

    def __init__(self, method="GFN2-xTB", charge=0, multiplicity=1, **kw):
        try:
            from tblite.interface import Calculator as _TBCalc  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "tblite is not installed; install `tblite` to use the xTB "
                "backend") from e
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
        self.method = method

    def _host_energy_gradient(self, coords, z):
        from tblite.interface import Calculator as TBCalc
        calc = TBCalc(self.method, np.asarray(z, dtype=int), coords,
                      charge=self.charge,
                      uhf=self.multiplicity - 1)
        solvation = self.options.get("solvation")
        if solvation:
            calc.add(solvation[0], solvation[1])
        calc.set("verbosity", 0)
        res = calc.singlepoint()
        return float(res.get("energy")), np.asarray(res.get("gradient"))


@register_calculator("pyscf")
class PySCF(HostCalculator):
    """HF/DFT through PySCF: method ("B3LYP", "HF", ...), basis
    ("6-31G*", ...), per-element basis overrides (sub_basis) and ECPs,
    and a TDA excited state (excited_state > 0)."""

    def __init__(self, method="B3LYP", basis="6-31G*", charge=0,
                 multiplicity=1, sub_basis=None, ecp=None, excited_state=0,
                 **kw):
        try:
            import pyscf  # noqa: F401
        except ImportError as e:
            raise ImportError("pyscf is not installed") from e
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
        self.method = method
        self.basis = basis
        self.sub_basis = sub_basis or {}
        self.ecp = ecp
        self.excited_state = int(excited_state)

    def _build_mf(self, coords, z):
        from pyscf import gto, dft, scf
        basis = (dict(self.sub_basis, default=self.basis)
                 if self.sub_basis else self.basis)
        mol = gto.M(
            atom=[(int(zi), tuple(c * BOHR2ANGSTROM))
                  for zi, c in zip(z, coords)],
            basis=basis, ecp=self.ecp,
            charge=self.charge, spin=self.multiplicity - 1,
            unit="Angstrom",
        )
        if self.method.upper() in ("HF", "RHF", "UHF"):
            mf = scf.UHF(mol) if self.multiplicity > 1 else scf.RHF(mol)
        else:
            mf = dft.UKS(mol) if self.multiplicity > 1 else dft.RKS(mol)
            mf.xc = self.method
        return mf

    def _host_wavefunction(self, coords, z):
        """(eps, C, S, occ) numpy arrays for the NRO analysis
        (analysis/mo.py host_orbitals)."""
        mf = self._build_mf(coords, z)
        mf.kernel()
        return (np.asarray(mf.mo_energy), np.asarray(mf.mo_coeff),
                np.asarray(mf.get_ovlp()), np.asarray(mf.mo_occ))

    def _host_energy_gradient(self, coords, z):
        mf = self._build_mf(coords, z)
        e = mf.kernel()
        if self.excited_state > 0:
            # TDA excited-state gradient
            from pyscf import tdscf
            td = tdscf.TDA(mf)
            td.nstates = max(3, self.excited_state)
            td.kernel()
            g = td.nuc_grad_method().kernel(state=self.excited_state)
            e = float(mf.e_tot + td.e[self.excited_state - 1])
            return float(e), np.asarray(g)
        g = mf.nuc_grad_method().kernel()
        return float(e), np.asarray(g)


@register_calculator("psi4")
class Psi4(HostCalculator):
    """Psi4 through its python API: method such as "b3lyp/6-31g*";
    options memory and n_threads (the -mem and -core flags)."""

    def __init__(self, method="b3lyp/6-31g*", charge=0, multiplicity=1, **kw):
        try:
            import psi4  # noqa: F401
        except ImportError as e:
            raise ImportError("psi4 is not installed") from e
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
        self.method = method

    def _geometry(self, psi4, coords, z):
        lines = [f"{self.charge} {self.multiplicity}"]
        for zi, c in zip(z, coords * BOHR2ANGSTROM):
            lines.append(
                f"{z_to_symbol(zi)} {c[0]:.12f} {c[1]:.12f} {c[2]:.12f}")
        return psi4.geometry("\n".join(lines))

    def _host_energy_gradient(self, coords, z):
        import psi4
        if self.options.get("memory"):
            psi4.set_memory(str(self.options["memory"]))
        if self.options.get("n_threads"):
            psi4.set_num_threads(int(self.options["n_threads"]))
        mol = self._geometry(psi4, coords, z)
        psi4.core.be_quiet()
        g, wfn = psi4.gradient(self.method, molecule=mol, return_wfn=True)
        return float(wfn.energy()), np.asarray(g)

    def _host_wavefunction(self, coords, z):
        """(eps, C, S, occ) numpy arrays for the NRO analysis."""
        import psi4
        mol = self._geometry(psi4, coords, z)
        psi4.core.be_quiet()
        _e, wfn = psi4.energy(self.method, molecule=mol, return_wfn=True)
        s = psi4.core.MintsHelper(wfn.basisset()).ao_overlap()
        occ = np.zeros(wfn.nmo())
        occ[:wfn.nalpha()] += 1.0
        occ[:wfn.nbeta()] += 1.0
        return (np.asarray(wfn.epsilon_a()), np.asarray(wfn.Ca()),
                np.asarray(s), occ)


def _ase_energy_gradient(atoms, calc):
    """(E Hartree, g Hartree/Bohr) of an ase.Atoms under calc, from ASE's
    eV and eV/Angstrom forces."""
    from ase import units as aseu
    atoms.calc = calc
    e = atoms.get_potential_energy() / aseu.Hartree
    g = -atoms.get_forces() / aseu.Hartree / ANGSTROM2BOHR
    return float(e), np.asarray(g)


@register_calculator("ase")
class ASEBridge(HostCalculator):
    """Any ASE calculator (ORCA, Gaussian, MACE, fairchem, ...): pass a
    constructed one as `ase_calc=`, or a `software_type=` name resolved
    through `setup_ase_calculator` and software_path.conf."""

    def __init__(self, ase_calc=None, software_type=None, charge=0,
                 multiplicity=1, **kw):
        try:
            import ase  # noqa: F401
        except ImportError as e:
            raise ImportError("ase is not installed") from e
        factory_kw = {k: kw.pop(k) for k in
                      ("software_path_dict", "functional", "basis_set",
                       "memory", "conf_path") if k in kw}
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
        if ase_calc is None and software_type is not None:
            ase_calc = setup_ase_calculator(
                software_type, charge=charge, multiplicity=multiplicity,
                **factory_kw)
        if ase_calc is None:
            raise ValueError("pass ase_calc=<constructed ASE calculator> "
                             "or software_type=<orca|gaussian|...>")
        self.ase_calc = ase_calc

    def _host_energy_gradient(self, coords, z):
        import ase
        atoms = ase.Atoms(numbers=np.asarray(z, int),
                          positions=coords * BOHR2ANGSTROM)
        return _ase_energy_gradient(atoms, self.ase_calc)


def read_software_path(path="./software_path.conf"):
    """External QM binary paths for the ASE bridge: `name::path` lines,
    or `name = path`; keys lower-cased."""
    import os

    paths = {}
    if not os.path.exists(path):
        return paths
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "::" in line:
                key, val = line.split("::", 1)
            elif "=" in line:
                key, val = line.split("=", 1)
            else:
                continue
            paths[key.strip().lower()] = val.strip()
    return paths


def setup_ase_calculator(software_type, charge=0, multiplicity=1,
                         software_path_dict=None, functional="b3lyp",
                         basis_set="def2-SVP", memory=None, conf_path=None,
                         **kw):
    """A constructed ASE calculator for a named external code: orca,
    gaussian, nwchem, gamessus, mopac, mace_mp, mace_off, uma-*
    (fairchem), gfn0-xtb, gfn-ff, gxtb_dev. Binary paths come from
    `software_path_dict` or software_path.conf."""
    if software_path_dict is None:
        software_path_dict = read_software_path(conf_path
                                                or "./software_path.conf")
    st = software_type.lower()
    spin = multiplicity

    if st == "orca":
        from ase.calculators.orca import ORCA, OrcaProfile
        path = software_path_dict.get("orca")
        profile = OrcaProfile(command=path) if path else None
        return ORCA(profile=profile, charge=charge, mult=spin,
                    orcasimpleinput=f"{functional} {basis_set} EnGrad",
                    **kw)
    if st == "gaussian":
        from ase.calculators.gaussian import Gaussian
        path = software_path_dict.get("gaussian")
        extra = ({"command": f"{path} < PREFIX.com > PREFIX.log"}
                 if path else {})
        if memory:
            extra["mem"] = memory
        return Gaussian(method=functional, basis=basis_set, charge=charge,
                        mult=spin, **extra, **kw)
    if st == "nwchem":
        from ase.calculators.nwchem import NWChem
        return NWChem(xc=functional, basis=basis_set, charge=charge, **kw)
    if st == "gamessus":
        from ase.calculators.gamess_us import GAMESSUS
        path = software_path_dict.get("gamessus")
        extra = {"command": path} if path else {}
        return GAMESSUS(xc=functional, basis=basis_set, charge=charge,
                        mult=spin, **extra, **kw)
    if st == "mopac":
        from ase.calculators.mopac import MOPAC
        return MOPAC(charge=charge, **kw)
    if st in ("mace_mp", "mace_off"):
        # foundation ML potentials
        if st == "mace_mp":
            from mace.calculators import mace_mp as _mk
        else:
            from mace.calculators import mace_off as _mk
        model = software_path_dict.get(st) or kw.pop("model", "medium")
        return _mk(model=model, **kw)
    if st.startswith("uma"):
        # fairchem UMA checkpoints
        from fairchem.core import FAIRChemCalculator
        path = software_path_dict.get(st)
        return FAIRChemCalculator(checkpoint_path=path, **kw)
    if st == "gfn0-xtb":
        import pygfn0
        return pygfn0.GFN0(charge=charge, **kw)
    if st == "gfn-ff":
        # the force field takes no charge
        import pygfnff
        return pygfnff.GFNFF(**kw)
    if st == "gxtb_dev":
        from pygxtb import PygxTB
        return PygxTB(charge=charge, **kw)
    raise ValueError(f"unsupported software type: {software_type}")


@register_calculator("dxtb")
class DXTB(HostCalculator):
    """xTB through dxtb, with torch autograd gradients on the host."""

    def __init__(self, method="GFN1-xTB", charge=0, multiplicity=1, **kw):
        try:
            import dxtb  # noqa: F401
        except ImportError as e:
            raise ImportError("dxtb (and torch) are required for the dxtb "
                              "backend") from e
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
        self.method = method

    def _host_energy_gradient(self, coords, z):
        import dxtb
        numbers = torch.tensor(np.asarray(z, dtype=int))
        positions = torch.tensor(coords, dtype=torch.float64,
                                 requires_grad=True)
        calc = dxtb.Calculator(numbers, dxtb.GFN1_XTB, opts={"verbosity": 0})
        with torch.enable_grad():
            e = calc.get_energy(positions, chrg=self.charge)
            (g,) = torch.autograd.grad(e, positions)
        return float(e.detach()), g.detach().numpy()


@register_calculator("gpaw")
class GPAW(HostCalculator):
    """GPAW periodic DFT through ASE: mode ("lcao"/"pw"), xc; options
    gpaw_kwargs."""

    def __init__(self, mode="lcao", xc="PBE", charge=0, multiplicity=1, **kw):
        try:
            import gpaw  # noqa: F401
            import ase  # noqa: F401
        except ImportError as e:
            raise ImportError("gpaw is not installed") from e
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
        self.mode = mode
        self.xc = xc

    def _host_energy_gradient(self, coords, z):
        import ase
        from gpaw import GPAW as _GPAW
        atoms = ase.Atoms(numbers=np.asarray(z, int),
                          positions=coords * BOHR2ANGSTROM)
        atoms.center(vacuum=4.0)
        return _ase_energy_gradient(
            atoms, _GPAW(mode=self.mode, xc=self.xc, txt=None,
                         **self.options.get("gpaw_kwargs", {})))


@register_calculator("pwscf")
class PWSCF(HostCalculator):
    """Quantum ESPRESSO's pw.x through ASE; the binary's path from
    software_path.conf ("pwscf"); options espresso_kwargs."""

    def __init__(self, pseudopotentials=None, charge=0, multiplicity=1, **kw):
        try:
            import ase  # noqa: F401
            from ase.calculators.espresso import Espresso  # noqa: F401
        except ImportError as e:
            raise ImportError("ase (with espresso support) is not "
                              "installed") from e
        super().__init__(charge=charge, multiplicity=multiplicity, **kw)
        self.pseudopotentials = pseudopotentials or {}

    def _host_energy_gradient(self, coords, z):
        import ase
        from ase.calculators.espresso import Espresso
        cmd = read_software_path().get("pwscf")
        atoms = ase.Atoms(numbers=np.asarray(z, int),
                          positions=coords * BOHR2ANGSTROM)
        atoms.center(vacuum=5.0)
        kw = dict(pseudopotentials=self.pseudopotentials,
                  **self.options.get("espresso_kwargs", {}))
        if cmd:
            kw["command"] = cmd
        return _ase_energy_gradient(atoms, Espresso(**kw))
