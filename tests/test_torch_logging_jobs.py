"""Port parity: logging_utils.py and jobs.py of multioptpy_tpu_torch
against the JAX package.

RunLogger fed by each package's optimize on an Ar4 cluster (LJ, FIRE, 6
steps, bond/angle/dihedral tracked) writes the same run_log.csv and
geometry_params.csv (headers equal, numbers to 1e-10 relative);
snapshot_config writes the same input.json for the same OptimizeConfig;
`optimize(..., timer=)` times one "step" and one "host" stage per
iteration in both packages; StageTimer's CSV, and profile_trace's
Chrome trace. The five Jobs run on the CPU (`device="cpu"`) against the
reference's: an LJ optimization, a Muller-Brown NEB, NVE MD from rest,
an EIP search and an AutoTS, each to 1e-10 Ha and 1e-8 Bohr; without a
device a Job asks for the card."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu import jobs as ref_jobs
from multioptpy_tpu import logging_utils as ref_log
from multioptpy_tpu.calculators.lj import LennardJones as RefLJ
from multioptpy_tpu.drivers.optimize import OptimizeConfig as RefConfig
from multioptpy_tpu.drivers.optimize import optimize as ref_optimize
from multioptpy_tpu.periodic import UFF_VDW_R
from multioptpy_tpu_torch import jobs, logging_utils
from multioptpy_tpu_torch.calculators.lj import LennardJones
from multioptpy_tpu_torch.calculators.model_surfaces import MB_MIN_A, MB_MIN_C
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize

torch.set_num_threads(1)

_R = float(UFF_VDW_R[18])
_AR4 = np.array([[0.0, 0.0, 0.0], [_R * 1.05, 0.1, 0.0],
                 [_R / 2, _R * 0.9, 0.2], [_R / 2, _R * 0.3, _R * 0.8]])
_Z = np.full(4, 18)
# criteria that no step of these short runs meets
_TIGHT = dict(max_force=1e-9, rms_force=1e-9, max_displacement=1e-9,
              rms_displacement=1e-9)
_TRACKED = [("bond", [1, 2]), ("angle", [1, 2, 3]),
            ("dihedral", [1, 2, 3, 4])]


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")]
                               for ln in lines[1:]])


def test_run_logger_and_snapshot_match_reference(tmp_path):
    kw = dict(method="fire", nsteps=6, **_TIGHT)
    ref_logger = ref_log.RunLogger(str(tmp_path / "ref"), _TRACKED)
    ref_timer = ref_log.StageTimer()
    ref_optimize(RefLJ(), jnp.asarray(_AR4), jnp.asarray(_Z),
                 config=RefConfig(**kw),
                 callback=ref_logger.make_callback(), timer=ref_timer)
    ref_logger.flush()
    ref_log.snapshot_config(str(tmp_path / "ref"), RefConfig(**kw),
                            extra={"input": "ar4.xyz"})
    logger = logging_utils.RunLogger(str(tmp_path / "port"), _TRACKED)
    timer = logging_utils.StageTimer()
    res = optimize(LennardJones(device="cpu"), torch.as_tensor(_AR4), _Z,
                   config=OptimizeConfig(**kw),
                   callback=logger.make_callback(), timer=timer,
                   device="cpu")
    logger.flush()
    logging_utils.snapshot_config(str(tmp_path / "port"),
                                  OptimizeConfig(**kw),
                                  extra={"input": "ar4.xyz"})
    for name in ("run_log.csv", "geometry_params.csv"):
        if name == "geometry_params.csv":
            head_a = (tmp_path / "ref" / name).read_text().splitlines()[0]
            head_b = (tmp_path / "port" / name).read_text().splitlines()[0]
            a = np.loadtxt(tmp_path / "ref" / name, delimiter=",", ndmin=2)
            b = np.loadtxt(tmp_path / "port" / name, delimiter=",", ndmin=2)
        else:
            head_a, a = _csv(tmp_path / "ref" / name)
            head_b, b = _csv(tmp_path / "port" / name)
        assert head_b == head_a
        assert b.shape == a.shape
        assert len(b) == res.n_iterations == 6
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-14)
    assert json.loads((tmp_path / "port" / "input.json").read_text()) == \
        json.loads((tmp_path / "ref" / "input.json").read_text())

    rep, ref_rep = timer.report(), ref_timer.report()
    assert set(rep) == set(ref_rep) == {"step", "host"}
    assert rep["step"]["count"] == rep["host"]["count"] == \
        ref_rep["step"]["count"] == res.n_iterations
    timer.write_csv(str(tmp_path / "stages.csv"))
    assert (tmp_path / "stages.csv").read_text().startswith(
        "stage,total_s,count,mean_ms\nstep,")


def test_stage_timer_and_profile_trace(tmp_path):
    """The chunked loop times its chunks; a stage given a CPU tensor does
    not synchronize a card; the trace is a Chrome trace file."""
    timer = logging_utils.StageTimer()
    optimize(LennardJones(device="cpu"), torch.as_tensor(_AR4), _Z,
             config=OptimizeConfig(method="fire", nsteps=7, scan_chunk=3,
                                   **_TIGHT),
             timer=timer, device="cpu")
    assert timer.report()["step"]["count"] == 3
    with timer.stage("x", block=torch.zeros(2)):
        pass
    assert timer.counts["x"] == 1
    with logging_utils.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert "traceEvents" in (tmp_path / "trace" / "trace.json").read_text()


def _mb(pt):
    return np.array([[pt[0], pt[1], 0.0]])


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=1e-10, atol=1e-8, err_msg=what)


def test_optimization_and_md_jobs_match_reference(tmp_path):
    xyz = tmp_path / "ar4.xyz"
    xyz.write_text("4\nar4\n" + "\n".join(
        f"Ar {x * 0.52917721067:.12f} {y * 0.52917721067:.12f} "
        f"{z * 0.52917721067:.12f}" for x, y, z in _AR4) + "\n")
    kw = dict(calculator="lj", method="fire", nsteps=8, **_TIGHT)
    a = ref_jobs.OptimizationJob(str(xyz), **kw).run()
    b = jobs.OptimizationJob(str(xyz), device="cpu", **kw).run()
    _close(b.coords.numpy(), a.coords, "optimization coords")
    _close(b.energy_history, a.energy_history, "optimization energies")
    # NVE from rest: no random draw
    kw = dict(calculator="lj", timestep_fs=2.0, n_steps=10,
              temperature=0.0, thermostat="none")
    a = ref_jobs.MDJob(str(xyz), **kw).run()
    b = jobs.MDJob(str(xyz), device="cpu", **kw).run()
    _close(b.trajectory, a.trajectory, "md trajectory")
    _close(b.energies, a.energies, "md energies")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the default device is valid")
        jobs.MDJob(str(xyz), **kw)


def test_neb_ieip_autots_jobs_match_reference():
    mb = dict(coords=_mb(MB_MIN_A), z=np.array([1]),
              calculator="muller_brown")
    end = _mb(MB_MIN_C)
    kw = dict(n_images=6, variant="neb", n_steps=10, k_spring=5e-4)
    a = ref_jobs.NEBJob(**mb, end_coords=jnp.asarray(end), **kw).run()
    b = jobs.NEBJob(**mb, end_coords=end, device="cpu", **kw).run()
    _close(b.path.numpy(), a.path, "neb path")
    _close(b.energies.numpy(), a.energies, "neb energies")
    kw = dict(engine="eip", n_steps=15)
    a = ref_jobs.IEIPJob(**mb, end_coords=jnp.asarray(end), **kw).run()
    b = jobs.IEIPJob(**mb, end_coords=end, device="cpu", **kw).run()
    _close(b.ts_guess.numpy(), a.ts_guess, "ieip ts guess")
    _close(b.ts_energy, a.ts_energy, "ieip ts energy")
    kw = dict(n_images=8, top_n_candidates=1)
    a = ref_jobs.AutoTSJob(**mb, product_coords=jnp.asarray(end), **kw).run()
    b = jobs.AutoTSJob(**mb, product_coords=end, device="cpu", **kw).run()
    _close(b.ts_coords.numpy(), a.ts_coords, "autots ts")
    _close(b.ts_energy, a.ts_energy, "autots ts energy")
    assert b.n_imaginary == a.n_imaginary
