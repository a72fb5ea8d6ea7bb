"""Port parity: multioptpy_tpu_torch.workflows.confsearch against the JAX
package. The LJ6 search of tests/test_confsearch.py, its early stop, the
non-stochastic search restricted to target atoms and the restart file
give the same conformer counts, candidates and rejections in both
packages. Their energies and coordinates are held to 1e-10 Ha and 1e-8
Bohr, or, where the RS-RFO relaxations amplify rounding, to ten times
how far the port itself moves when its start is perturbed by 1e-14 Bohr
(the witness; ROADMAP Queue 3), which must itself stay within
`WITNESS_CAP` (1e-8 Ha, 1e-4 Bohr: the LJ6 search's witness is 4.5e-10
Ha, 2.2e-5 Bohr along its clusters' soft modes). The kick alone
(`make_kick_relax`) on 2 members of an open-shell SQM2 cation agrees to
1e-10 Ha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators import LennardJones as RefLJ
from multioptpy_tpu.calculators.sqm import SQM2 as RefSQM2
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefOptConfig
from multioptpy_tpu.periodic import UFF_VDW_R
from multioptpy_tpu.workflows import confsearch as ref
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.sqm import SQM2
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig
from multioptpy_tpu_torch.workflows import confsearch

torch.set_num_threads(1)

RMIN = float(UFF_VDW_R[18])
_TIGHT = dict(method="rfo_fsb", max_force=1e-6, rms_force=7e-7,
              max_displacement=1e-4, rms_displacement=7e-5)
# the bound on the witness (energy Ha, coordinates Bohr)
WITNESS_CAP = (1e-8, 1e-4)
_LJ6 = dict(batch_size=8, base_gamma=60.0, kick_steps=40, relax_steps=60,
            preserve_bonds=False, dedupe_threshold=0.05, seed=1)


def _search(coords, n, cfg, witness=False, **kw):
    """(reference result, port result, port result from a start moved by
    1e-14 Bohr or None)."""
    opt = cfg.pop("opt", None)
    z = np.full(n, 18)
    r = ref.conformer_search(
        RefLJ(), jnp.asarray(coords), jnp.asarray(z),
        ref.ConfSearchConfig(**cfg, **({"opt": RefOptConfig(**opt)}
                                       if opt else {})),
        restart_file=kw.get("ref_restart"))
    pcfg = confsearch.ConfSearchConfig(
        **cfg, **({"opt": OptimizeConfig(**opt)} if opt else {}))
    p = confsearch.conformer_search(LennardJones(device="cpu"),
                                    torch.as_tensor(coords), z, pcfg,
                                    restart_file=kw.get("port_restart"),
                                    device="cpu")
    w = None
    if witness:
        moved = coords + 1e-14 * np.random.default_rng(0).standard_normal(
            coords.shape)
        w = confsearch.conformer_search(LennardJones(device="cpu"),
                                        torch.as_tensor(moved), z, pcfg,
                                        device="cpu")
    return r, p, w


def _assert_same(r, p, w=None):
    assert len(p.energies) == len(r.energies)
    assert p.n_generated == r.n_generated
    assert p.n_rejected_bonds == r.n_rejected_bonds
    assert p.n_nonfinite == 0
    assert np.all(np.diff(p.energies) >= -1e-12)
    tol_e, tol_x = 1e-10, 1e-8
    if w is not None:
        assert len(w.energies) == len(p.energies)
        w_e = np.abs(w.energies - p.energies).max()
        w_x = np.abs(w.conformers - p.conformers).max()
        assert w_e <= WITNESS_CAP[0] and w_x <= WITNESS_CAP[1]
        tol_e, tol_x = max(tol_e, 10 * w_e), max(tol_x, 10 * w_x)
    assert np.abs(p.energies - r.energies).max() <= tol_e
    assert np.abs(p.conformers - np.asarray(r.conformers)).max() <= tol_x


def _lj6():
    rng = np.random.default_rng(5)
    return rng.standard_normal((6, 3)) * RMIN * 0.5


def test_lj6_search_matches_reference():
    """tests/test_confsearch.py's LJ6 search, 2 of its 4 rounds."""
    r, p, w = _search(_lj6(), 6, dict(n_rounds=2, opt=_TIGHT, **_LJ6),
                      witness=True)
    assert len(p.energies) >= 2 and p.energies[0] < 0.0
    _assert_same(r, p, w)


def test_early_stop_matches_reference():
    r, p, w = _search(_lj6(), 6, dict(n_rounds=40, opt=_TIGHT,
                                      number_of_rank=1, number_of_lowest=1,
                                      **_LJ6), witness=True)
    assert p.n_generated < 40 * 8
    _assert_same(r, p, w)


def test_target_atoms_without_stochastic_seeds_match_reference():
    rng = np.random.default_rng(7)
    coords = rng.standard_normal((5, 3)) * RMIN * 0.5
    r, p, _ = _search(coords, 5, dict(
        n_rounds=2, batch_size=4, base_gamma=60.0, kick_steps=30,
        relax_steps=50, preserve_bonds=False, dedupe_threshold=0.05, seed=2,
        stochastic=False, target_atoms=(1, 3, 5)))
    _assert_same(r, p)
    with pytest.raises(ValueError):
        confsearch.conformer_search(
            LennardJones(device="cpu"), torch.as_tensor(coords),
            np.full(5, 18), confsearch.ConfSearchConfig(
                n_rounds=1, batch_size=2, target_atoms=(2,)), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        confsearch.conformer_search(
            LennardJones(device="cpu"), torch.as_tensor(coords),
            np.full(5, 18), mesh=object(), device="cpu")


def test_restart_file_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    coords = rng.standard_normal((5, 3)) * RMIN * 0.5
    cfg = dict(n_rounds=1, batch_size=4, base_gamma=60.0, kick_steps=30,
               relax_steps=50, preserve_bonds=False, dedupe_threshold=0.05,
               seed=3)
    paths = dict(ref_restart=str(tmp_path / "ref.npz"),
                 port_restart=str(tmp_path / "port.npz"))
    _search(coords, 5, dict(cfg), **paths)
    saved = confsearch.load_search_state(paths["port_restart"])
    want = ref.load_search_state(paths["ref_restart"])
    assert [len(x) for x in saved] == [len(x) for x in want]
    np.testing.assert_allclose(saved[1], want[1], rtol=0, atol=1e-10)
    assert saved[2] == want[2]
    # the second run resumes from the files: one more round each
    r, p, _ = _search(coords, 5, dict(cfg, seed=4), **paths)
    _assert_same(r, p)


def test_kick_on_an_sqm2_cation_matches_reference():
    """Two members of H2O+ kicked along different pairs and signs, 6 FIRE
    steps on SQM2 + AFIR: the kicked geometries' energies to 1e-10 Ha."""
    coords = np.array([[0.0, 0.0, 0.2217], [0.0, 1.43, -0.8867],
                       [0.0, -1.43, -0.8867]])
    z = np.array([8, 1, 1])
    rng = np.random.default_rng(4)
    batch = coords[None] + 0.05 * rng.standard_normal((2, 3, 3))
    w1 = np.array([[1.0, 0, 0], [0, 1.0, 0]])
    w2 = np.array([[0, 0, 1.0], [0, 0, 1.0]])
    signs = np.array([1.0, -1.0])
    ref_calc = RefSQM2(charge=1, multiplicity=2)
    got_calc = SQM2(charge=1, multiplicity=2, device="cpu")
    want = np.asarray(ref.make_kick_relax(ref_calc, jnp.asarray(z), 150.0, 6)(
        *(jnp.asarray(a) for a in (batch, w1, w2, signs))))
    got = confsearch.make_kick_relax(got_calc, z, 150.0, 6)(
        *(torch.as_tensor(a) for a in (batch, w1, w2, signs)))
    assert np.abs(got.numpy() - want).max() < 1e-8
    e_want = np.array([float(ref_calc.energy(jnp.asarray(x), jnp.asarray(z)))
                       for x in want])
    e_got = got_calc.energy(got, z).numpy()
    assert np.abs(e_got - e_want).max() < 1e-10
    assert np.abs(e_got - got_calc.energy(torch.as_tensor(batch), z).numpy()
                  ).min() > 1e-5
