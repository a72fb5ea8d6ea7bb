"""Port parity: every registered bias potential of multioptpy_tpu_torch
against the JAX package's, one at a time in a BiasEngine built from the
same configuration on a 6-atom molecule (C, O, N, H, H, C; f64): energy,
gradient and Hessian of two structures to 1e-10 relative. The ellipsoid
and spacer models relax their internal coordinates inside the energy and
enter detached, so their Hessians are held to the reference's, which
leave out the coupling through those coordinates by design. To stay
cheap, the ellipsoids relax on a 36-point grid with one Newton step, the
spacer for 30 steps, and the reference runs jit-compiled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.potentials import BiasEngine as RefEngine
from multioptpy_tpu.potentials import available_potentials as ref_available
from multioptpy_tpu.potentials import get_potential as ref_get
from multioptpy_tpu_torch.potentials import (BiasEngine, available_potentials,
                                             get_potential)

torch.set_num_threads(1)

_Z = np.array([6, 8, 7, 1, 1, 6])
_X0 = np.array([[0.0, 0.0, 0.0], [2.3, 0.2, -0.1], [-0.4, 2.5, 0.3],
                [-1.8, -0.9, 1.2], [0.6, -1.1, -1.8], [3.1, 2.6, 1.4]])
_F1, _F2 = [1, 2], [4, 5]

_CONFIGS = {
    "afir": dict(gamma=150.0, fragm_1=_F1, fragm_2=_F2, element_z=_Z),
    "keep": dict(spring_const=0.5, distance=1.0, atom_pair=[1, 2]),
    "keep_v2": dict(spring_const=0.3, distance=1.5, fragm_1=_F1,
                    fragm_2=_F2),
    "keep_aniso": dict(spring_consts=[0.1, 0.2, 0.3],
                       distances=[0.5, 0.4, 0.3], atom_pair=[1, 3]),
    "keep_anharmonic": dict(spring_const=0.4, well_depth=0.1, distance=1.6,
                            atom_pair=[2, 3]),
    "keep_angle": dict(spring_const=0.2, angle=100.0, atoms=[1, 2, 3]),
    "keep_angle_v2": dict(spring_const=0.2, angle=80.0, fragm_1=[1],
                          fragm_2=[2, 3], fragm_3=_F2),
    "keep_dihedral": dict(spring_const=0.1, angle=30.0, atoms=[1, 2, 3, 4]),
    "keep_dihedral_v2": dict(spring_const=0.1, angle=-40.0, fragm_1=[1],
                             fragm_2=[2], fragm_3=[3], fragm_4=_F2),
    "keep_dihedral_cos": dict(potential_const=0.05, angle=20.0,
                              multiplicity=2, fragm_1=[1], fragm_2=[2],
                              fragm_3=[3, 6], fragm_4=_F2),
    "keep_out_of_plane": dict(spring_const=0.1, angle=10.0,
                              atoms=[1, 2, 3, 4]),
    "keep_out_of_plane_v2": dict(spring_const=0.1, angle=-5.0, fragm_1=[1],
                                 fragm_2=[2, 6], fragm_3=[3], fragm_4=_F2),
    "well": dict(wall_energy=50.0, limits=[0.3, 0.6, 0.8, 1.0],
                 fragm_1=_F1, fragm_2=_F2),
    "well_vp": dict(wall_energy=50.0, limits=[0.3, 0.6, 1.0, 1.3],
                    point=[0.2, 0.1, 0.0], atoms=[1, 2, 3, 4, 5, 6]),
    "well_wall": dict(wall_energy=50.0, limits=[-0.5, 0.0, 0.8, 1.4],
                      axis="x", atoms=[1, 2, 3, 4, 5, 6]),
    "well_around": dict(wall_energy=50.0, limits=[0.4, 0.8, 1.0, 1.3],
                        center_fragm=[1], atoms=[2, 3, 4, 5, 6]),
    "void_point": dict(spring_const=0.3, distance=0.8, order=4.0,
                       point=[0.5, 0.5, 0.5], atom=[1, 2]),
    "lj_repulsive_scale": dict(well_scale=1.0, dist_scale=0.8, fragm_1=_F1,
                               fragm_2=_F2, element_z=_Z),
    "lj_repulsive_value": dict(well_value_kjmol=5.0, dist_value_ang=1.4,
                               fragm_1=_F1, fragm_2=_F2, element_z=_Z),
    "lj_repulsive_v2": dict(well_scale=1.0, dist_scale=0.8, exp_a=10.0,
                            exp_b=5.0, fragm_1=_F1, fragm_2=_F2,
                            element_z=_Z),
    "lj_repulsive_gaussian": dict(well_depth=5.0, dist=1.4,
                                  gau_well_depth=3.0, gau_dist=1.2,
                                  gau_range=1.0, fragm_1=_F1, fragm_2=_F2,
                                  element_z=_Z),
    "cone": dict(well_value=5.0, dist_value=2.5, cone_angle=60.0, center=1,
                 three_atoms=[2, 3, 4], target=[5, 6], element_z=_Z),
    "lj_repulsive_v2_probe": dict(well=1.0, dist=1.0, length_ang=1.0,
                                  const_rep=1.0, const_attr=1.0,
                                  order_rep=12.0, order_attr=6.0,
                                  center=[1, 2], target=[3, 4, 5, 6],
                                  element_z=_Z, mode="value"),
    "mechano_force": dict(force_pn=500.0, atoms_1=[1, 2], atoms_2=[3, 4]),
    "mechano_force_v2": dict(force_pn=500.0, atom_pair=[1, 4]),
    "electrostatic_fragment": dict(charge_scale=1.0, fragm_1=_F1,
                                   fragm_2=_F2, element_z=_Z),
    "electrostatic_atom_pair": dict(charge_scale=0.5, atoms=[1, 2, 3, 6],
                                    element_z=_Z),
    "value_range": dict(upper_const=5.0, lower_const=4.0,
                        upper_distance=1.2, lower_distance=0.9, fragm_1=_F1,
                        fragm_2=_F2),
    "gaussian_metadyn": dict(height_kjmol=5.0, width_ang=0.3,
                             atom_pair=[1, 2], max_hills=8),
    "universal": dict(const=10.0, atoms=[1, 2, 3, 4]),
    "flux": dict(const=[0.01, 0.02, 0.03], order=[2.0, 2.0, 4.0],
                 direction=[0.5, -0.5, 1.0], atoms=[1, 6]),
    "nanoreactor": dict(inner_wall_ang=0.6, outer_wall_ang=1.2,
                        contraction_time=100.0, expansion_time=100.0,
                        contraction_k=0.01, expansion_k=0.02, element_z=_Z),
    "idpp_bias": dict(target_coords=_X0 * 1.1, strength=2.0),
    "cfb_enm": dict(reference_coords=_X0, element_z=_Z, k=0.1,
                    tolerance=0.05, scale=1.6),
    "asym_ellipsoid": dict(atoms=[(1, 2), (3, 6)], offtgt=[[4], []],
                           eps=[1.0, 0.8],
                           sig=[[1.5, 1.2, 1.4, 1.1, 1.3, 1.0],
                                [1.1, 1.3, 1.0, 1.2, 1.4, 1.5]],
                           dist=[1.0, 1.2], element_z=_Z, n_grid=36,
                           newton_steps=1),
    "spacer": dict(target=[1, 2, 3, 4, 5, 6], n_particles=4, sigma_ang=2.0,
                   depth_kjmol=1.0, cavity_scaling=1.5, element_z=_Z,
                   n_relax=30),
}


def _structures():
    rng = np.random.default_rng(12)
    return _X0[None] + 0.15 * rng.standard_normal((2, 6, 3))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-300)


def test_every_reference_potential_is_registered():
    assert available_potentials() == ref_available()
    assert sorted(_CONFIGS) == available_potentials()
    with pytest.raises(KeyError, match="available"):
        get_potential("no_such_potential")


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_potential_matches_reference(name):
    ref_pot = ref_get(name, **_CONFIGS[name])
    pot = get_potential(name, **_CONFIGS[name])
    if name == "gaussian_metadyn":
        for cv in (4.2, 4.5, 4.9):
            ref_pot.deposit(cv)
            pot.deposit(cv)
    ref, got = RefEngine([ref_pot]), BiasEngine([pot])
    ref_eg, ref_h = jax.jit(ref.energy_and_gradient), jax.jit(ref.hessian)
    x = _structures()
    xt = torch.as_tensor(x)
    e, g = got.energy_and_gradient(xt)
    h = got.hessian(xt)
    assert e.shape == (2,) and g.shape == x.shape and h.shape == (2, 18, 18)
    for k in range(len(x)):
        re, rg = ref_eg(jnp.asarray(x[k]))
        rh = ref_h(jnp.asarray(x[k]))
        assert abs(float(re)) > 0.0, name
        assert _rel(e[k].item(), re) < 1e-10, name
        assert _rel(g[k].numpy(), rg) < 1e-10, name
        assert _rel(h[k].numpy(), rh) < 1e-10, name


def test_spacer_effective_hessian_matches_reference():
    cfg = _CONFIGS["spacer"]
    ref_pot = ref_get("spacer", **cfg)
    pot = get_potential("spacer", **cfg)
    want = np.asarray(jax.jit(ref_pot.effective_hessian)(jnp.asarray(_X0)))
    got = pot.effective_hessian(torch.as_tensor(_X0)).numpy()
    assert _rel(got, want) < 1e-9
