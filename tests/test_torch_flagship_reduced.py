"""Port parity, slow: the flagship AutoTS on the Diels-Alder reactant,
SQM2 f64, through the JAX package on the CPU and through the port on the
CPU, in the reduced configuration of tests/test_tpu_flagship_smoke.py and
in the full one of tests/test_flagship_autots.py.

TS energies agree within 1e-5 Ha and barriers within 1e-4 Ha (the neutral
closed shell limits energy parity to ~1e-7 Ha per evaluation through the
reference's f32 Fermi count, and the pipeline's hundreds of steps carry
that difference along their paths), and both find the same number of
imaginary modes: one in the full configuration. The reduced one finds
none on either side: its 8-image band falls monotonically from the
reactant, so no interior maximum exists to refine.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flagship_reduced.py -m slow -s
"""

import time

import numpy as np
import pytest
import torch


def _config(opt, neb, irc, autots, full):
    model = "model:lindh2007d3_raw"
    if full:
        return autots.AutoTSConfig(
            afir_list=[(300.0, [1], [11]), (300.0, [4], [12])],
            afir_opt=opt.OptimizeConfig(method="rfo_fsb", nsteps=300,
                                        init_hessian=model, fc_count=-1,
                                        mfc_count=30),
            n_images=16,
            neb=neb.NEBConfig(variant="cineb", n_steps=250, k_spring=0.01,
                              climbing_start=80, fmax=5e-4, dt0=0.05,
                              dt_max=0.2, redistribute="linear",
                              redistribute_every=25),
            top_n_candidates=2,
            saddle=opt.OptimizeConfig(method="rfo_bofill", saddle_order=1,
                                      nsteps=120, fc_count=5,
                                      init_hessian="exact"),
            irc=irc.IRCConfig(method="lqa", step_size=0.1, n_steps=70),
            endpoint_opt=opt.OptimizeConfig(method="rfo_fsb", nsteps=150,
                                            init_hessian=model))
    return autots.AutoTSConfig(
        afir_list=[(300.0, [1], [11]), (300.0, [4], [12])],
        afir_opt=opt.OptimizeConfig(method="rfo_fsb", nsteps=150,
                                    init_hessian=model, fc_count=-1,
                                    mfc_count=30),
        n_images=8,
        neb=neb.NEBConfig(variant="cineb", n_steps=80, k_spring=0.01,
                          climbing_start=30, fmax=5e-4, dt0=0.05,
                          dt_max=0.2),
        top_n_candidates=1,
        saddle=opt.OptimizeConfig(method="rfo_bofill", saddle_order=1,
                                  nsteps=80, fc_count=5,
                                  init_hessian="exact"),
        irc=irc.IRCConfig(method="lqa", step_size=0.12, n_steps=30),
        endpoint_opt=opt.OptimizeConfig(method="rfo_fsb", nsteps=80,
                                        init_hessian=model),
    )


@pytest.mark.slow
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_flagship_autots_matches_reference(full):
    import importlib

    import jax.numpy as jnp

    from multioptpy_tpu.calculators.sqm import SQM2 as RefSQM2
    from multioptpy_tpu.io.fixtures import diels_alder_reactant
    from multioptpy_tpu_torch.calculators.sqm import SQM2

    mods = [importlib.import_module(f"{pkg}.{m}")
            for pkg in ("multioptpy_tpu", "multioptpy_tpu_torch")
            for m in ("drivers.optimize", "drivers.neb", "drivers.irc",
                      "workflows.autots")]
    coords, z = diels_alder_reactant()

    t0 = time.perf_counter()
    ref = mods[3].autots(RefSQM2(), jnp.asarray(coords, jnp.float64),
                         jnp.asarray(z), _config(*mods[:4], full))
    t_ref = time.perf_counter() - t0
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    got = mods[7].autots(SQM2(device="cpu"), coords, z,
                         _config(*mods[4:], full), device="cpu")
    t_got = time.perf_counter() - t0
    print(f"\nreference (JAX, CPU): {t_ref:.1f} s {ref.stage_seconds}; "
          f"TS E {ref.ts_energy!r}, barriers {ref.barrier_forward!r} / "
          f"{ref.barrier_backward!r}, n_imaginary {ref.n_imaginary}, NEB "
          f"energies {np.asarray(ref.neb_energies).tolist()}")
    print(f"port (torch, CPU): {t_got:.1f} s {got.stage_seconds}; "
          f"TS E {got.ts_energy!r}, barriers {got.barrier_forward!r} / "
          f"{got.barrier_backward!r}, n_imaginary {got.n_imaginary}, NEB "
          f"energies {got.neb_energies.tolist()}")

    assert int(got.n_imaginary) == int(ref.n_imaginary) == int(full)
    assert np.isfinite(got.barrier_forward) and got.barrier_forward > 0
    assert got.ts_energy == pytest.approx(ref.ts_energy, abs=1e-5)
    assert got.barrier_forward == pytest.approx(ref.barrier_forward,
                                                abs=1e-4)
    assert got.barrier_backward == pytest.approx(ref.barrier_backward,
                                                 abs=1e-4)
