"""AutoTS: automated transition-state pipeline.

Counterpart of `multioptpy_tpu/workflows/autots.py`: step 1 AFIR-biased
RS-RFO relaxation (then the unbiased product relaxation), step 2 CI-NEB on
the AFIR trajectory, step 3 saddle refinement of the top NEB maxima with
exact Hessians and normal modes, step 4 LQA IRC and endpoint
optimizations. Every stage runs on the calculator's device; geometries
pass between stages as tensors. The sharded path (`mesh`) arrives with
ROADMAP Queue 1 item 17.

Entry points:
  autots(...)            full pipeline from reactant (+ AFIR spec or an
                         explicit product geometry)
  refine_saddle(...)     step-3 equivalent: RS-I-RFO with saddle_order=1
"""

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from multioptpy_tpu_torch.analysis.vibrations import count_imaginary
from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.drivers.irc import IRCConfig, IRCResult, irc
from multioptpy_tpu_torch.drivers.neb import (NEBConfig, interpolate_linear,
                                              neb)
from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig, optimize
from multioptpy_tpu_torch.interpolation import linear_resample
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.potentials import BiasEngine, get_potential
from multioptpy_tpu_torch.units import BOHR2ANGSTROM


@dataclasses.dataclass(frozen=True)
class AutoTSConfig:
    # step 1: AFIR exploration (ignored when product_coords given)
    afir_gamma: float = 150.0
    afir_fragm_1: Sequence[int] = ()
    afir_fragm_2: Sequence[int] = ()
    # multi-AFIR: (gamma, fragm_1, fragm_2) triples applied together;
    # overrides the single-AFIR fields when non-empty
    afir_list: Sequence = ()
    afir_opt: OptimizeConfig = dataclasses.field(
        default_factory=lambda: OptimizeConfig(
            method="rfo_fsb", nsteps=300, fc_count=10))
    # step 2: NEB
    n_images: int = 12
    # one image per `node_distance` Angstrom of initial-path arc length
    # (overrides n_images when set), clipped to [4, 64]
    node_distance_ang: Optional[float] = None
    neb: NEBConfig = dataclasses.field(default_factory=lambda: NEBConfig(
        variant="cineb", n_steps=300, k_spring=5e-4, climbing_start=30,
        fmax=5e-4, dt0=0.05, dt_max=0.4))
    use_idpp: bool = False
    # step 3: refine the N highest NEB local maxima
    top_n_candidates: int = 3
    saddle: OptimizeConfig = dataclasses.field(
        default_factory=lambda: OptimizeConfig(
            method="rfo_bofill", saddle_order=1, nsteps=100, fc_count=5,
            init_hessian="exact"))
    # step 4: IRC
    irc: IRCConfig = dataclasses.field(default_factory=IRCConfig)
    optimize_endpoints: bool = True
    endpoint_opt: OptimizeConfig = dataclasses.field(
        default_factory=lambda: OptimizeConfig(method="rfo_fsb", nsteps=200))
    # steps between the host's checks for every optimization/NEB stage
    # whose own config leaves scan_chunk unset; 0 keeps per-step loops
    scan_chunk: int = 16


class AutoTSResult(NamedTuple):
    ts_coords: torch.Tensor
    ts_energy: float
    n_imaginary: int
    barrier_forward: float       # E_ts - E(reactant-side IRC end)
    barrier_backward: float
    irc_result: IRCResult
    reactant_coords: torch.Tensor
    product_coords: torch.Tensor
    reactant_energy: float
    product_energy: float
    neb_path: torch.Tensor
    neb_energies: np.ndarray
    afir_trajectory: Optional[np.ndarray]
    # per-candidate refinement diagnostics: [{index, neb_energy, energy,
    # n_imaginary, converged, selected, coords}]
    candidates: tuple = ()
    # wall-clock per stage: {"step1_afir", "step2_neb", "step3_refine",
    # "step4_irc"} in seconds
    stage_seconds: dict = {}


def refine_saddle(calc, ts_guess, z, config=None, bias_engine=None,
                  device=None):
    """Step-3 equivalent: first-order saddle refinement via the
    image-function RS-RFO."""
    config = config or OptimizeConfig(method="rfo_bofill", saddle_order=1,
                                      nsteps=100, fc_count=5,
                                      init_hessian="exact")
    return optimize(calc, ts_guess, z, bias_engine=bias_engine,
                    config=config, device=device)


def _select_candidate(refined):
    """Tiered TS pick over refined candidates (coords, energy, n_imag,
    hessian, converged, neb_idx), kept in descending NEB-energy order:
    converged first-order saddle, else any first-order saddle, else any
    converged point, else the rate-limiting candidate."""
    for cond in (lambda r: r[4] and r[2] == 1,
                 lambda r: r[2] == 1,
                 lambda r: r[4]):
        tier = [r for r in refined if cond(r)]
        if tier:
            return tier[0]
    return refined[0]


def _chunked_stages(config):
    """Every stage whose config leaves scan_chunk unset takes
    config.scan_chunk."""
    if not (config.scan_chunk and config.scan_chunk > 1):
        return config

    def chunked(oc):
        return (oc if oc.scan_chunk
                else dataclasses.replace(oc, scan_chunk=config.scan_chunk))
    return dataclasses.replace(
        config, afir_opt=chunked(config.afir_opt),
        saddle=chunked(config.saddle),
        endpoint_opt=chunked(config.endpoint_opt), neb=chunked(config.neb))


def autots(calc, reactant, z, config=AutoTSConfig(), product_coords=None,
           bias_engine=None, afir_trajectory=None, verbose=False,
           mesh=None, mesh_axis="batch", device=None, stage_hook=None):
    """Full AutoTS pipeline on one reactant (N,3) (Bohr).

    `afir_trajectory`: optional (T,N,3) step-1 trajectory, used as the NEB
    initial path when `product_coords` is also given. `verbose`: stage
    banners and wall clock on stdout. `device` (None means the CUDA card)
    must be where `calc` lives. `stage_hook(name, **detail)`, if given, is
    called as each stage of `stage_seconds` ends, under the same name, for
    counters that are read per stage: "step1_afir" with the AFIR result
    (`afir`, None when `product_coords` is given), "step2_neb" with the
    initial path and the NEB result (`path0`, `neb`), "step3_refine" and
    "step4_irc" with none."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded AutoTS (mesh) arrives with ROADMAP Queue 1 item 17")
    del mesh_axis
    if config.use_idpp:
        raise NotImplementedError(
            "IDPP initial paths arrive with ROADMAP Queue 1 item 11")
    dev = resolve_device(device)
    t0 = time.perf_counter()

    def _vlog(msg):
        if verbose:
            print(f"# autots [{time.perf_counter() - t0:8.1f} s] {msg}",
                  flush=True)

    def as_coords(x):
        return (x.detach().to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev))

    reactant = as_coords(reactant)
    z = np.asarray(z)
    afir_traj = (np.asarray(afir_trajectory)
                 if afir_trajectory is not None else None)
    config = _chunked_stages(config)
    stage_seconds = {}
    mark = [t0]

    def stage_done(name, **detail):
        now = time.perf_counter()
        stage_seconds[name] = round(now - mark[0], 2)
        mark[0] = now
        if stage_hook is not None:
            stage_hook(name, **detail)

    # ---- step 1: product generation via AFIR -------------------------
    res1 = None
    if product_coords is None:
        if config.afir_list:
            triples = list(config.afir_list)
        elif len(config.afir_fragm_1) and len(config.afir_fragm_2):
            triples = [(config.afir_gamma, config.afir_fragm_1,
                        config.afir_fragm_2)]
        else:
            raise ValueError("give product_coords or AFIR fragments")
        afir = BiasEngine([get_potential("afir", gamma=g, fragm_1=list(f1),
                                         fragm_2=list(f2), element_z=z)
                           for g, f1, f2 in triples])
        _vlog("step1: AFIR-biased optimization")
        res1 = optimize(calc, reactant, z, bias_engine=afir,
                        config=config.afir_opt, record_trajectory=True,
                        device=dev)
        afir_traj = res1.coords_history
        # relax the AFIR product on the unbiased surface
        _vlog("step1: unbiased product relaxation")
        product_coords = optimize(calc, res1.coords, z,
                                  config=config.endpoint_opt,
                                  device=dev).coords
    product_coords = as_coords(product_coords)
    stage_done("step1_afir", afir=res1)

    # ---- step 2: NEB on the AFIR trajectory --------------------------
    n_images = config.n_images
    use_traj = afir_traj is not None and len(afir_traj) >= 3
    if config.node_distance_ang:
        if use_traj:
            src = np.concatenate([afir_traj,
                                  product_coords.cpu().numpy()[None]])
        else:
            src = np.stack([reactant.cpu().numpy(),
                            product_coords.cpu().numpy()])
        seg = np.sqrt(((src[1:] - src[:-1]) ** 2).sum(axis=(1, 2)))
        arc_ang = float(seg.sum()) * BOHR2ANGSTROM
        n_images = int(np.clip(round(arc_ang / config.node_distance_ang) + 1,
                               4, 64))
    if use_traj:
        full = torch.cat([torch.as_tensor(afir_traj, dtype=reactant.dtype,
                                          device=dev),
                          product_coords[None]])
        path0 = linear_resample(full, n_images)
    else:
        path0 = interpolate_linear(reactant, product_coords, n_images)
    _vlog(f"step2: NEB ({path0.shape[0]} images x {path0.shape[1]} atoms)")
    neb_res = neb(calc, path0, z, config.neb, bias_engine=bias_engine,
                  device=dev)
    stage_done("step2_neb", path0=path0, neb=neb_res)

    # ---- step 3: refine the top-N NEB local maxima -------------------
    e_path = neb_res.energies.cpu().numpy()
    maxima = [i for i in range(1, len(e_path) - 1)
              if e_path[i] >= e_path[i - 1] and e_path[i] >= e_path[i + 1]]
    if not maxima:
        maxima = [neb_res.ts_index]
    maxima.sort(key=lambda i: e_path[i], reverse=True)
    candidates = maxima[:max(1, config.top_n_candidates)]

    refined = []   # (coords, energy, n_imag, hessian, converged, neb_idx)
    for idx in candidates:
        _vlog(f"step3: saddle refinement of NEB image {idx}")
        res3 = refine_saddle(calc, neb_res.path[idx], z, config.saddle,
                             bias_engine, device=dev)
        _vlog("step3: exact Hessian + normal modes")
        h, freqs = hosteval.hessian_and_modes(calc, res3.coords[None], z)
        ni = count_imaginary(freqs[0])
        # identical refined TSs collapse
        c_np = res3.coords.cpu().numpy()
        if any(np.sqrt(np.mean((c_np - r[0].cpu().numpy()) ** 2)) < 1e-3
               for r in refined):
            continue
        refined.append((res3.coords, float(res3.energy), ni, h[0],
                        bool(res3.converged), int(idx)))

    pick = _select_candidate(refined)
    ts_coords, ts_energy, n_imag, h_ts = pick[:4]
    stage_done("step3_refine")
    cand_info = tuple(
        {"index": r[5], "neb_energy": float(e_path[r[5]]),
         "energy": r[1], "n_imaginary": r[2], "converged": r[4],
         "selected": r is pick, "coords": r[0].cpu().numpy()}
        for r in refined)

    # ---- step 4: IRC + endpoint optimization -------------------------
    _vlog("step4: IRC")
    irc_res = irc(calc, ts_coords, z, hessian=h_ts, config=config.irc,
                  bias_engine=bias_engine, device=dev)
    end_f = as_coords(irc_res.forward_path[-1])
    end_b = as_coords(irc_res.backward_path[-1])
    if config.optimize_endpoints:
        _vlog("step4: endpoint optimizations")
        # an endpoint optimization that ends non-finite falls back to the
        # raw IRC terminus so the barriers stay reportable
        ends = []
        for start in (end_f, end_b):
            cand = optimize(calc, start, z, config=config.endpoint_opt,
                            device=dev).coords
            ok = bool(torch.isfinite(cand).all())
            ends.append(cand if ok else start)
            if not ok:
                _vlog("step4: an endpoint diverged - keeping the raw IRC "
                      "terminus")
        end_f, end_b = ends
    e_f = float(hosteval.energy(calc, end_f[None], z)[0])
    e_b = float(hosteval.energy(calc, end_b[None], z)[0])
    stage_done("step4_irc")

    return AutoTSResult(
        ts_coords=ts_coords, ts_energy=ts_energy, n_imaginary=n_imag,
        barrier_forward=ts_energy - e_f, barrier_backward=ts_energy - e_b,
        irc_result=irc_res,
        reactant_coords=end_f, product_coords=end_b,
        reactant_energy=e_f, product_energy=e_b,
        neb_path=neb_res.path, neb_energies=e_path,
        afir_trajectory=afir_traj, candidates=cand_info,
        stage_seconds=stage_seconds,
    )


# ---------------------------------------------------------------------------
# reference v1 legacy config translation
# ---------------------------------------------------------------------------

# NEB force-law switches: reference argparse dest name -> variant string
_V1_VARIANTS = (("QSMv2", "qsm2"), ("QSM", "qsm"), ("OM", "om"),
                ("LUP", "lup"), ("BNEB2", "bneb2"), ("BNEB", "bneb"),
                ("DNEB", "dneb"), ("NESB", "nesb"), ("DMF", "dmf"),
                ("EWBNEB", "ewbneb"))

# in-loop redistribution switches
_V1_REDIST = (("align_distances", "linear"),
              ("align_distances_energy", "energy"),
              ("align_distances_energy_predicted", "pred"),
              ("align_distances_ritz_energy_predicted", "ritz"),
              ("align_distances_spline", "spline"),
              ("align_distances_spline_ver2", "spline2"),
              ("align_distances_geodesic", "geodesic"),
              ("align_distances_bernstein", "bernstein"),
              ("align_distances_bernstein_energy", "bernstein_energy"),
              ("align_distances_adaptive_energy", "adaptive"))


def _v1_opt_config(settings, base):
    """stepN_settings -> OptimizeConfig derived from `base`; keys are the
    reference's optimizer argparse dest names."""
    kw = {}
    om = settings.get("opt_method") or []
    if isinstance(om, str):
        om = [om]
    if len(om) >= 2:
        # two entries = sigmoid force-switching pair
        kw["switch_method"], kw["method"] = om[0], om[1]
    elif om:
        kw["method"] = om[0]
    if "NSTEP" in settings:
        kw["nsteps"] = int(settings["NSTEP"])
    fc = int(settings.get("calc_exact_hess", -1) or -1)
    if fc > 0:
        kw["fc_count"] = fc
        kw["init_hessian"] = "exact"
    mh = settings.get("use_model_hessian")
    if mh:
        # bare true / null = flag without argument -> 'fischerd3old'
        kw["init_hessian"] = "model:%s" % (mh if isinstance(mh, str)
                                           else "fischerd3old")
    if settings.get("tight_convergence_criteria"):
        kw.update(max_force=1.5e-5, rms_force=1e-5,
                  max_displacement=6e-5, rms_displacement=4e-5)
    if settings.get("loose_convergence_criteria"):
        kw.update(max_force=3e-3, rms_force=2e-3,
                  max_displacement=1e-2, rms_displacement=7e-3)
    if settings.get("max_trust_radius") is not None:
        kw["trust_radius_ang"] = float(settings["max_trust_radius"])
    if settings.get("min_trust_radius") is not None:
        kw["trust_radius_min_ang"] = float(settings["min_trust_radius"])
    return dataclasses.replace(base, **kw)


def _v1_afir_list(ma):
    """manual_AFIR value -> ((gamma, fragm_1, fragm_2), ...) from repeated
    [gamma f1 f2] triples with 1-indexed "1,2-5" fragments."""
    from multioptpy_tpu_torch.cli import num_parse
    ma = list(ma or [])
    out = []
    for i in range(0, len(ma) - 2, 3):
        f1, f2 = ma[i + 1], ma[i + 2]
        out.append((float(ma[i]),
                    tuple(num_parse(str(f1))),
                    tuple(num_parse(str(f2)))))
    return tuple(out)


def autots_config_from_v1(cfg, n_images_default=12):
    """Translate the reference's v1 legacy AutoTS config (top-level
    step1_settings..step4_settings keys) into an AutoTSConfig.

    Returns (config, flow): `flow` carries the v1 switches the caller
    interprets (skip_step1 / skip_to_step4 / run_step4 / save_pict /
    frequency_analysis, calculator hints, node_distance and the failure
    knobs)."""
    base = AutoTSConfig(n_images=n_images_default)
    s1 = dict(cfg.get("step1_settings", {}))
    s2 = dict(cfg.get("step2_settings", {}))
    s3 = dict(cfg.get("step3_settings", {}))
    s4 = dict(cfg.get("step4_settings", {}))

    kw = {"afir_opt": _v1_opt_config(s1, base.afir_opt),
          "saddle": _v1_opt_config(s3, base.saddle)}
    if "top_n_candidates" in cfg:
        kw["top_n_candidates"] = int(cfg["top_n_candidates"])
    afir = _v1_afir_list(s1.get("manual_AFIR"))
    if len(afir) == 1:
        kw.update(afir_gamma=afir[0][0], afir_fragm_1=afir[0][1],
                  afir_fragm_2=afir[0][2])
    elif afir:
        kw["afir_list"] = afir

    # step 2 -> NEBConfig
    nkw = {}
    if "NSTEP" in s2:
        nkw["n_steps"] = int(s2["NSTEP"])
    for dest, variant in _V1_VARIANTS:
        if s2.get(dest):
            nkw["variant"] = variant
            break
    ci = s2.get("apply_CI_NEB")
    if ci is not None and int(ci) < 99999:
        nkw["climbing_start"] = int(ci)
    if s2.get("memory_limited_BFGS") or s2.get("global_quasi_newton"):
        nkw["optimizer"] = "lbfgs"
    elif int(s2.get("steepest_descent", 99999) or 99999) < 99999:
        nkw["optimizer"] = "sd"
    for dest, scheme in _V1_REDIST:
        every = int(s2.get(dest, 0) or 0)
        if every > 0:
            nkw.update(redistribute=scheme, redistribute_every=every)
    sg = str(s2.get("align_distances_savgol", "0,0,0")).split(",")
    if sg and sg[0].strip() and int(sg[0]) > 0:
        nkw.update(redistribute="savgol", redistribute_every=int(sg[0]))
        if len(sg) >= 3:
            nkw.update(savgol_window=int(sg[1]), savgol_order=int(sg[2]))
    if nkw:
        kw["neb"] = dataclasses.replace(base.neb, **nkw)
    if s2.get("use_image_dependent_pair_potential"):
        kw["use_idpp"] = True
    part = int(s2.get("partition", 0) or 0)
    if part > 0:
        kw["n_images"] = part
    for nd_key in ("node_distance", "node_distance_spline",
                   "node_distance_bernstein"):
        if s2.get(nd_key) is not None:
            kw["node_distance_ang"] = float(s2[nd_key])
            break
    if s2.get("node_distance_savgol"):
        first = str(s2["node_distance_savgol"]).split(",")[0]
        if first.strip():
            kw["node_distance_ang"] = float(first)

    # step 4 -> IRCConfig + endpoint optimization
    irc_spec = list(s4.get("intrinsic_reaction_coordinates", []) or [])
    if irc_spec:
        # [step_size, n_steps, method]
        kw["irc"] = IRCConfig(
            step_size=float(irc_spec[0]) if len(irc_spec) > 0 else 0.05,
            n_steps=int(irc_spec[1]) if len(irc_spec) > 1 else 200,
            method=str(irc_spec[2]) if len(irc_spec) > 2 else "lqa")
    ep = s4.get("step4b_opt_method") or s4.get("opt_method")
    if ep:
        kw["endpoint_opt"] = _v1_opt_config(
            {"opt_method": ep,
             "NSTEP": s4.get("NSTEP", base.endpoint_opt.nsteps),
             "tight_convergence_criteria":
                 s4.get("tight_convergence_criteria")},
            base.endpoint_opt)

    flow = {"skip_step1": bool(cfg.get("skip_step1", False)),
            "skip_to_step4": bool(cfg.get("skip_to_step4", False)),
            "run_step4": bool(cfg.get("run_step4", True)),
            "save_pict": bool(s2.get("save_pict", False)),
            "frequency_analysis": bool(s3.get("frequency_analysis", False)
                                       or s4.get("frequency_analysis",
                                                 False)),
            "node_distance": s2.get("node_distance"),
            "usextb": (s1.get("usextb") or s2.get("usextb")
                       or s3.get("usextb") or s4.get("usextb")),
            "electronic_charge": s1.get("electronic_charge"),
            "spin_multiplicity": s1.get("spin_multiplicity"),
            "dissociate_check": (float(s1["dissociate_check"])
                                 if s1.get("dissociate_check") else None),
            "detect_negative_eigenvalues":
                bool(s3.get("detect_negative_eigenvalues", False))}
    return dataclasses.replace(base, **kw), flow
