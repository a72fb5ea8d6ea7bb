"""Port parity: the host QM bridges of multioptpy_tpu_torch
(calculators/host.py) against the JAX package's, on the same fake
libraries as the reference's own contract tests: each test puts a minimal
fake module with the library's public API shape into sys.modules and
drives both bridges through `energy_and_gradient` (the port on a batch of
three structures, which `_host_batched` fans out over its thread pool),
against a known analytic surface and the reference, to 1e-12 relative:
units, signs, option passthrough. The ASE factory and software_path.conf
resolve alike. Without its library each bridge raises the ImportError
that names it, before it asks for a device; `optmain`'s backend flags
reach them."""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import host as ref_host
from multioptpy_tpu_torch.calculators import host
from multioptpy_tpu_torch.units import ANGSTROM2BOHR, BOHR2ANGSTROM

torch.set_num_threads(1)

WATER = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.81], [1.75, 0.0, -0.48]])
Z = np.array([8, 1, 1])
HARTREE_EV = 27.211386245988


def _harmonic(coords_bohr):
    """E = 0.5 sum |r|^2 (Bohr), g = r."""
    c = np.asarray(coords_bohr, dtype=np.float64)
    return 0.5 * float(np.sum(c * c)), c.copy()


@pytest.fixture
def fake(monkeypatch):
    """Install fake modules: fake(name, module)."""
    def install(name, module):
        monkeypatch.setitem(sys.modules, name, module)
    return install


def _check(ref_calc, calc, rtol_analytic=1e-12):
    """`rtol_analytic` against the analytic surface (1e-10 where the
    geometry goes through text with 12 decimals, as the reference's own
    test holds Psi4); the port against the reference to 1e-12."""
    batch = np.stack([WATER, WATER * 1.05, WATER * 0.95])
    e, g = calc.energy_and_gradient(torch.as_tensor(batch), Z)
    assert e.dtype == g.dtype == torch.float64 and e.shape == (3,)
    for k, x in enumerate(batch):
        e_ref, g_ref = _harmonic(x)
        assert float(e[k]) == pytest.approx(e_ref, rel=rtol_analytic)
        np.testing.assert_allclose(g[k].numpy(), g_ref, rtol=rtol_analytic)
        e_b, g_b = ref_calc.energy_and_gradient(jnp.asarray(x),
                                                jnp.asarray(Z))
        assert float(e[k]) == pytest.approx(float(e_b), rel=1e-12)
        np.testing.assert_allclose(g[k].numpy(), np.asarray(g_b),
                                   rtol=1e-12)


def _fake_ase(fake):
    class FakeAtoms:
        def __init__(self, numbers=None, positions=None):
            self.numbers = np.asarray(numbers)
            self.positions = np.asarray(positions)   # Angstrom
            self.calc = None

        def center(self, vacuum=None):
            pass

        def get_potential_energy(self):
            return _harmonic(self.positions * ANGSTROM2BOHR)[0] * HARTREE_EV

        def get_forces(self):
            g_bohr = _harmonic(self.positions * ANGSTROM2BOHR)[1]
            return -g_bohr * HARTREE_EV / BOHR2ANGSTROM

    mod = types.ModuleType("ase")
    mod.Atoms = FakeAtoms
    units = types.ModuleType("ase.units")
    units.Hartree = HARTREE_EV
    mod.units = units
    fake("ase", mod)
    fake("ase.units", units)
    return mod


def test_tblite_bridge_matches_reference(fake):
    record = []

    class FakeRes:
        def __init__(self, e, g):
            self._d = {"energy": e, "gradient": g}

        def get(self, key):
            return self._d[key]

    class FakeTBCalc:
        def __init__(self, method, numbers, positions, charge=0, uhf=0):
            record.append((method, tuple(numbers), charge, uhf))
            self.positions = np.asarray(positions)
            self.added = []

        def add(self, *a):
            record.append(("add",) + a)

        def set(self, k, v):
            pass

        def singlepoint(self):
            return FakeRes(*_harmonic(self.positions))

    mod = types.ModuleType("tblite")
    iface = types.ModuleType("tblite.interface")
    iface.Calculator = FakeTBCalc
    mod.interface = iface
    fake("tblite", mod)
    fake("tblite.interface", iface)
    kw = dict(method="GFN1-xTB", charge=1, multiplicity=2,
              solvation=("alpb", "water"))
    _check(ref_host.TBLite(**kw), host.TBLite(device="cpu", **kw))
    assert set(record) == {("GFN1-xTB", (8, 1, 1), 1, 1),
                           ("add", "alpb", "water")}


def test_psi4_bridge_matches_reference(fake):
    record = {}

    class FakeWfn:
        def __init__(self, e):
            self._e = e

        def energy(self):
            return self._e

    mod = types.ModuleType("psi4")
    mod.core = types.SimpleNamespace(
        be_quiet=lambda: record.update(quiet=True))
    mod.set_memory = lambda m: record.update(memory=m)
    mod.set_num_threads = lambda n: record.update(threads=n)

    def geometry(text):
        record["first_line"] = text.splitlines()[0]
        rows = [ln.split() for ln in text.splitlines()
                if len(ln.split()) == 4]
        return np.array([[float(v) for v in r[1:]] for r in rows])

    def gradient(method, molecule=None, return_wfn=False):
        record["method"] = method
        e, g = _harmonic(molecule * ANGSTROM2BOHR)
        return g, FakeWfn(e)

    mod.geometry = geometry
    mod.gradient = gradient
    fake("psi4", mod)
    kw = dict(method="b3lyp/6-31g*", charge=-1, multiplicity=2,
              memory="4GB", n_threads=3)
    _check(ref_host.Psi4(**kw), host.Psi4(device="cpu", **kw),
           rtol_analytic=1e-10)
    assert record == {"first_line": "-1 2", "method": "b3lyp/6-31g*",
                      "quiet": True, "memory": "4GB", "threads": 3}


def test_ase_bridges_match_reference(fake):
    """ASE's eV and eV/Angstrom forces become Hartree and Hartree/Bohr
    gradients; GPAW's calculator gets its mode and xc."""
    _fake_ase(fake)
    _check(ref_host.ASEBridge(ase_calc=object()),
           host.ASEBridge(ase_calc=object(), device="cpu"))
    created = []
    gpaw_mod = types.ModuleType("gpaw")
    gpaw_mod.GPAW = lambda mode=None, xc=None, txt=None, **kw: \
        created.append((mode, xc)) or object()
    fake("gpaw", gpaw_mod)
    _check(ref_host.GPAW(mode="pw", xc="PBE"),
           host.GPAW(mode="pw", xc="PBE", device="cpu"))
    assert set(created) == {("pw", "PBE")}
    espresso = types.ModuleType("ase.calculators.espresso")
    espresso.Espresso = lambda **kw: created.append(
        tuple(sorted(kw["pseudopotentials"].items()))) or object()
    fake("ase.calculators", types.ModuleType("ase.calculators"))
    fake("ase.calculators.espresso", espresso)
    pseudo = {"O": "O.upf", "H": "H.upf"}
    _check(ref_host.PWSCF(pseudopotentials=pseudo),
           host.PWSCF(pseudopotentials=pseudo, device="cpu"))
    assert created[-1] == (("H", "H.upf"), ("O", "O.upf"))


def test_ase_factory_and_software_paths_match_reference(fake, tmp_path):
    captured = []

    class FakeORCA:
        def __init__(self, profile=None, charge=0, mult=1,
                     orcasimpleinput=""):
            captured.append((profile.command, charge, mult,
                             orcasimpleinput))

    class FakeProfile:
        def __init__(self, command=None):
            self.command = command

    _fake_ase(fake)
    orca = types.ModuleType("ase.calculators.orca")
    orca.ORCA, orca.OrcaProfile = FakeORCA, FakeProfile
    fake("ase.calculators", types.ModuleType("ase.calculators"))
    fake("ase.calculators.orca", orca)
    gfn0 = types.ModuleType("pygfn0")
    gfn0.GFN0 = lambda charge=0: ("gfn0", charge)
    fake("pygfn0", gfn0)
    conf = tmp_path / "software_path.conf"
    conf.write_text("# comment\norca::/opt/orca/orca\n"
                    "gaussian = /usr/bin/g16\nmalformed line\n")
    assert host.read_software_path(str(conf)) == \
        ref_host.read_software_path(str(conf)) == \
        {"orca": "/opt/orca/orca", "gaussian": "/usr/bin/g16"}
    kw = dict(charge=-1, multiplicity=3, conf_path=str(conf),
              functional="wb97x", basis_set="def2-TZVP")
    for mod in (ref_host, host):
        mod.setup_ase_calculator("orca", **kw)
        assert mod.setup_ase_calculator("GFN0-xTB", charge=2,
                                         conf_path=str(conf)) == ("gfn0", 2)
        with pytest.raises(ValueError):
            mod.setup_ase_calculator("nonesuch", conf_path=str(conf))
    assert captured[0] == captured[1] == (
        "/opt/orca/orca", -1, 3, "wb97x def2-TZVP EnGrad")
    bridge = host.ASEBridge(software_type="orca", device="cpu", **kw)
    assert isinstance(bridge.ase_calc, FakeORCA)


def test_pyscf_bridge_matches_reference(fake):
    record = []

    class FakeMF:
        def __init__(self, mol, kind):
            self.mol, self.kind, self.xc = mol, kind, None

        def kernel(self):
            e, self._g = _harmonic(self.mol.coords_bohr)
            self.e_tot = e
            return e

        def nuc_grad_method(self):
            outer = self
            return types.SimpleNamespace(kernel=lambda: outer._g)

        def get_ovlp(self):
            return np.eye(2)

        @property
        def mo_energy(self):
            return np.array([-0.5, 0.25]) * self.e_tot

        @property
        def mo_coeff(self):
            c = np.cos(self.e_tot)
            return np.array([[c, -np.sin(self.e_tot)],
                             [np.sin(self.e_tot), c]])

        mo_occ = np.array([2.0, 0.0])

    def fake_m(atom=None, basis=None, ecp=None, charge=0, spin=0,
               unit=None):
        record.append((str(basis), str(ecp), charge, spin, unit))
        mol = types.SimpleNamespace()
        mol.coords_bohr = np.array([list(a[1]) for a in atom]) \
            * ANGSTROM2BOHR
        return mol

    mod = types.ModuleType("pyscf")
    mod.gto = types.SimpleNamespace(M=fake_m)
    mod.dft = types.SimpleNamespace(RKS=lambda m: FakeMF(m, "RKS"),
                                    UKS=lambda m: FakeMF(m, "UKS"))
    mod.scf = types.SimpleNamespace(RHF=lambda m: FakeMF(m, "RHF"),
                                    UHF=lambda m: FakeMF(m, "UHF"))
    fake("pyscf", mod)
    kw = dict(method="B3LYP", basis="6-31G*", charge=0, multiplicity=3,
              sub_basis={"O": "cc-pVTZ"}, ecp={"O": "lanl2dz"})
    ref_calc, calc = ref_host.PySCF(**kw), host.PySCF(device="cpu", **kw)
    _check(ref_calc, calc)
    assert set(record) == {(str({"O": "cc-pVTZ", "default": "6-31G*"}),
                            str({"O": "lanl2dz"}), 0, 2, "Angstrom")}
    # the wavefunction contract the NRO analysis reads
    for a, b in zip(ref_calc._host_wavefunction(WATER, Z),
                    calc._host_wavefunction(WATER, Z)):
        np.testing.assert_array_equal(b, a)


def test_dxtb_bridge_matches_reference(fake):
    class FakeDxtbCalc:
        def __init__(self, numbers, par, opts=None):
            pass

        def get_energy(self, positions, chrg=0):
            return 0.5 * (positions ** 2).sum()

    mod = types.ModuleType("dxtb")
    mod.Calculator = FakeDxtbCalc
    mod.GFN1_XTB = object()
    fake("dxtb", mod)
    _check(ref_host.DXTB(), host.DXTB(device="cpu"))


@pytest.mark.parametrize("name,lib", [
    ("tblite", "tblite"), ("pyscf", "pyscf"), ("psi4", "psi4"),
    ("ase", "ase"), ("dxtb", "dxtb"), ("gpaw", "gpaw"), ("pwscf", "ase")])
def test_absent_libraries_raise_their_import_error(name, lib, monkeypatch):
    """The gate comes first: no device is asked for (the default would be
    the card)."""
    from multioptpy_tpu_torch.calculators.base import get_calculator

    for mod in list(sys.modules):
        if mod == lib or mod.startswith(lib + "."):
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, lib, None)
    with pytest.raises(ImportError, match=lib):
        get_calculator(name)


def test_optmain_backend_flags_reach_the_bridges(tmp_path, monkeypatch):
    """-xtb with -alpb, -pyscf with -func/-bs/-sub_bs/-ecp/-u/-grid/-es,
    -dxtb, -os/-osp and -calc psi4 with -mem/-core build the bridges
    with the reference's keywords (the constructors are intercepted)."""
    from multioptpy_tpu import cli as ref_cli
    from multioptpy_tpu_torch import cli

    seen = {}

    def grab(tag):
        def ctor(**kw):
            kw.pop("device", None)
            seen.setdefault(tag, []).append(kw)
            raise ImportError(tag)
        return ctor

    xyz = tmp_path / "w.xyz"
    xyz.write_text("3\nw\nO 0 0 0\nH 0 0 0.96\nH 0.93 0 -0.25\n")
    flag_sets = [["-xtb", "GFN1-xTB", "-alpb", "water"],
                 ["-pyscf", "-func", "PBE0", "-bs", "def2-SVP", "-sub_bs",
                  "O", "cc-pVTZ", "-ecp", "O", "lanl2dz", "-u", "-grid",
                  "4", "-es", "2"],
                 ["-dxtb", "GFN1-xTB"],
                 ["-os", "orca", "-osp", str(tmp_path / "paths.conf")],
                 ["-calc", "psi4", "-mem", "8GB", "-core", "4"]]
    from multioptpy_tpu.calculators import base as ref_base
    from multioptpy_tpu_torch.calculators import base

    # every backend module is registered (host above); then intercept
    for mod, reg in ((ref_cli, ref_base), (cli, base)):
        reg.available_calculators()
        for name in ("tblite", "pyscf", "dxtb", "ase", "psi4"):
            monkeypatch.setitem(reg._REGISTRY, name,
                                grab(f"{reg.__name__}:{name}"))
        for flags in flag_sets:
            argv = [str(xyz), *flags, "-c", "1", "-m", "2"]
            p = mod._base_parser("t")
            args = p.parse_known_args(argv + (["--device", "cpu"]
                                              if mod is cli else []))[0]
            with pytest.raises(ImportError):
                mod._make_calculator(args)
    ref_kw = {k.split(":")[1]: v for k, v in seen.items()
              if k.startswith("multioptpy_tpu.")}
    port_kw = {k.split(":")[1]: v for k, v in seen.items()
               if k.startswith("multioptpy_tpu_torch.")}
    assert port_kw == ref_kw and set(port_kw) == {"tblite", "pyscf", "dxtb",
                                                  "ase", "psi4"}
