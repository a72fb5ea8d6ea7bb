"""Port parity: calculators/sqm.py of multioptpy_tpu_torch against the JAX
package (energy components, gradients, Hessian, parameter tables).

The energy and gradient comparisons use the +1 cations: their Fermi level
lies inside a partly filled level, where the reference's mixed-precision
Fermi search is well conditioned. For closed shells with a gap of many kT
the reference's chemical potential is set by f32 rounding (see
`test_f64_fermi_level_counts_electrons_in_f64`), so no port can match it
beyond ~1e-7 Ha there.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import sqm as ref_sqm
from multioptpy_tpu.hessian import dispersion as ref_disp
from multioptpy_tpu.io.fixtures import s8_crown
from multioptpy_tpu.periodic import COVALENT_RADII_1 as REF_RCOV
from multioptpy_tpu.periodic import UFF_VDW_R as REF_UFF
from multioptpy_tpu_torch.calculators import sqm
from multioptpy_tpu_torch.io.xyz import read_xyz
from multioptpy_tpu_torch.periodic import symbols_to_z
from multioptpy_tpu_torch.units import ANGSTROM2BOHR

torch.set_num_threads(1)

_WATER = (np.array([[0.0, 0.0, 0.0], [0.0, 1.1, -0.5], [0.0, -1.0, -0.65]])
          * ANGSTROM2BOHR, np.array([8, 1, 1]))


def _hcn():
    sym, c = read_xyz(pathlib.Path(__file__).resolve().parent.parent
                      / "examples" / "ab" / "hcn.xyz")
    return c * ANGSTROM2BOHR, symbols_to_z(sym)


_MOLS = {"water": lambda: _WATER, "hcn": _hcn, "s8": s8_crown}


def _ref_tables():
    """The JAX package's own tables, keyed as `sqm.tables()`."""
    t = {k: np.asarray(v) for k, v in ref_sqm._T.items()}
    r = ref_sqm
    t.update(
        g1s_a=r._G1S_A, g1s_c=r._G1S_C, g2sp_a=r._G2SP_A, g2s_c=r._G2S_C,
        g2p_c=r._G2P_C, g3sp_a=r._G3SP_A, g3s_c=r._G3S_C, g3p_c=r._G3P_C,
        g3d_a=r._G3D_A, g3d_c=r._G3D_C, c2s_d=r._C2S_D,
        wolfsberg=np.array([r._K_WH, r._K_SP, r._K_PP]),
        srb=np.array([r._SRB_K, r._SRB_ETA, r._SRB_GSCAL, r._SRB_C1,
                      r._SRB_C2]),
        srb_en=r._SRB_EN, srb_r0=r._SRB_R0, rep_cn0=r._REP_CN0,
        d2_c6_jnm6=ref_disp.D2_C6_JNM6, d2_vdw_ang=ref_disp.D2_VDW_ANG,
        d4_r4r2=ref_disp.D4_R4R2, d4_en=ref_disp.D4_EN,
        d4_damping=np.array([ref_disp.D4_S6, ref_disp.D4_S8, ref_disp.D4_A1,
                             ref_disp.D4_A2, ref_disp.D4_GA, ref_disp.D4_GC]),
        covalent_radii_1=REF_RCOV, uff_vdw_r=REF_UFF)
    return t


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_params_from_numpy_bit_for_bit(dtype):
    mine = sqm.params_from_numpy(sqm.tables(), "cpu", dtype)
    theirs = sqm.params_from_numpy(_ref_tables(), "cpu", dtype)
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key].dtype == theirs[key].dtype, key
        assert torch.equal(mine[key], theirs[key]), key


@pytest.mark.parametrize("cls", ["SQM", "SQM2"])
@pytest.mark.parametrize("mol", ["water", "hcn", "s8"])
def test_energy_terms_and_gradient_match_reference(mol, cls):
    coords, z = _MOLS[mol]()
    ref_calc = getattr(ref_sqm, cls)(charge=1)
    calc = getattr(sqm, cls)(charge=1, device="cpu")

    def f(c):
        t = ref_calc.energy_terms(c, z)
        return t["eht"] + t["eeq"] + t["rep"] + t["disp"] + t["srb"], t

    (_, t_ref), g_ref = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(coords))
    x = torch.as_tensor(coords)[None]
    t = calc.energy_terms(x, z)
    for key, val in t_ref.items():
        np.testing.assert_allclose(t[key][0].detach().numpy(),
                                   np.asarray(val), rtol=1e-10, atol=1e-14,
                                   err_msg=f"{mol} {cls} {key}")
    _, g = calc.energy_and_gradient(x, z)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(g_ref), rtol=0,
                               atol=1e-9)


def test_batched_energy_equals_one_at_a_time():
    coords, z = _WATER
    rng = np.random.default_rng(1)
    batch = coords[None] + 0.05 * rng.standard_normal((3, 3, 3))
    calc = sqm.SQM2(device="cpu")
    e = calc.energy(torch.as_tensor(batch), z)
    for i in range(3):
        e_i = calc.energy(torch.as_tensor(batch[i:i + 1]), z)
        np.testing.assert_allclose(e[i].item(), e_i.item(), rtol=1e-13)


def test_numerical_hessian_matches_reference():
    coords, z = _WATER
    ref_calc = ref_sqm.SQM2(charge=1)
    h_ref = jax.jit(lambda c: ref_calc.hessian(c, z))(jnp.asarray(coords))
    h = sqm.SQM2(charge=1, device="cpu").hessian(
        torch.as_tensor(coords)[None], z)
    np.testing.assert_allclose(h[0].numpy(), np.asarray(h_ref), rtol=0,
                               atol=1e-7)


def test_band_energy_pallas_matches_xla():
    """eigh_impl="pallas" on the CPU is the round-robin Jacobi: the same
    band energy as the library eigh, and as the reference's own route."""
    coords, z = _hcn()
    x = torch.as_tensor(coords)[None]
    e_p = sqm.SQM2(charge=1, eigh_impl="pallas", device="cpu").energy(x, z)
    e_x = sqm.SQM2(charge=1, eigh_impl="xla", device="cpu").energy(x, z)
    np.testing.assert_allclose(e_p.item(), e_x.item(), rtol=1e-12)
    ref_calc = ref_sqm.SQM2(charge=1, eigh_impl="pallas")
    e_ref = jax.jit(lambda c: ref_calc.energy(c, z))(jnp.asarray(coords))
    np.testing.assert_allclose(e_p.item(), float(e_ref), rtol=1e-12)


def test_default_band_eigh_is_the_library_eigh_on_the_cpu():
    """The default eigh_impl "auto" is one route for the CLI and library
    callers: torch.linalg.eigh on a CPU tensor (the Jacobi kernel on a CUDA
    one), the same band energy as "xla" bit for bit."""
    coords, z = _hcn()
    x = torch.as_tensor(coords)[None]
    calc = sqm.SQM2(charge=1, device="cpu")
    assert calc.eigh_impl == "auto"
    e_x = sqm.SQM2(charge=1, eigh_impl="xla", device="cpu").energy(x, z)
    assert torch.equal(calc.energy(x, z), e_x)


def test_f64_fermi_level_counts_electrons_in_f64():
    """Pins a reference fault. With a HOMO-LUMO gap of ~40 kT the
    reference's f32 electron count rounds to n_elec across most of the
    gap, so its chemical potential stops where the HOMO deficit is one
    f32 ulp and its occupations miss n_elec by ~1e-7. The port counts in
    f64: its occupations sum to n_elec and its energy stays within the
    reference's rounding (< 1e-6 Ha) of the reference's."""
    eps = np.array([-1.225, -0.734, -0.618, -0.544, 0.312, 0.877,
                    1.837, 1.837, 1.837, 1.837, 1.837, 1.837])
    occ_ref, _ = ref_sqm._fermi_occupations(jnp.asarray(eps), 8.0, 0.005)
    occ, _ = sqm._fermi_occupations(torch.as_tensor(eps)[None], 8.0, 0.005)
    assert abs(occ.sum().item() - 8.0) < 1e-12
    assert abs(float(jnp.sum(occ_ref)) - 8.0) > 1e-7
    f = sqm._free_energy(torch.as_tensor(eps)[None], occ, 0.005).item()
    f_ref = float(jnp.sum(occ_ref * eps))
    assert abs(f - f_ref) < 1e-6


def test_f32_fermi_bisection_matches_reference():
    eps = np.array([-0.9, -0.5, -0.31, -0.3, 0.2, 0.8], np.float32)
    occ_ref, mu_ref = ref_sqm._fermi_occupations(jnp.asarray(eps), 5.0,
                                                 0.005)
    occ, mu = sqm._fermi_occupations(torch.as_tensor(eps)[None], 5.0, 0.005)
    assert occ.dtype == torch.float32
    np.testing.assert_allclose(occ[0].numpy(), np.asarray(occ_ref),
                               atol=1e-5)
    np.testing.assert_allclose(mu.item(), float(mu_ref), atol=1e-6)


def test_overlap_blocks_fast_path_matches_reference():
    coords, z = _WATER
    alpha, cs, cp = sqm._primitive_params(z)
    ref = ref_sqm._overlap_blocks(jnp.asarray(coords), jnp.asarray(alpha),
                                  jnp.asarray(cs), jnp.asarray(cp))
    got = sqm._overlap_blocks(torch.as_tensor(coords)[None],
                              *(torch.as_tensor(t) for t in (alpha, cs, cp)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=1e-13)


def test_cg_solve_value_and_grad_match_reference():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((2, 5, 5))
    a = m @ np.swapaxes(m, -1, -2) + np.eye(5)
    b = rng.standard_normal((2, 5))
    probe = rng.standard_normal((2, 5))
    loss_ref = lambda a_, b_: jnp.sum(jax.vmap(ref_sqm._cg_solve)(a_, b_)
                                      * probe)
    x_ref = jax.vmap(ref_sqm._cg_solve)(jnp.asarray(a), jnp.asarray(b))
    ga_ref, gb_ref = jax.grad(loss_ref, argnums=(0, 1))(jnp.asarray(a),
                                                         jnp.asarray(b))
    at = torch.as_tensor(a).requires_grad_(True)
    bt = torch.as_tensor(b).requires_grad_(True)
    x = sqm._cg_solve(at, bt)
    (x * torch.as_tensor(probe)).sum().backward()
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(x_ref),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga_ref),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_ref),
                               rtol=1e-8, atol=1e-11)


def test_f32_energy_close_to_f64():
    coords, z = s8_crown()
    calc = sqm.SQM(device="cpu")
    e64 = calc.energy(torch.as_tensor(coords)[None], z)
    e32, g32 = calc.energy_and_gradient(
        torch.as_tensor(coords, dtype=torch.float32)[None], z)
    assert e32.dtype == torch.float32 and torch.isfinite(g32).all()
    np.testing.assert_allclose(e32.item(), e64.item(), rtol=1e-5)
