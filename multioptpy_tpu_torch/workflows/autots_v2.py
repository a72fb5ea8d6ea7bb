"""AutoTS v2 — JSON-driven dynamic workflow engine.

Counterpart of `multioptpy_tpu/workflows/autots_v2.py` (the reference's
Wrapper/autots.py AutoTSWorkflow_v2): the config carries a "workflow" list
of step entries

    {"step": "afir" | "opt" | "neb" | "saddle" | "irc" | "freq" | "confsearch",
     "settings_key": "...",        # which settings block to use
     "repeat": N,                   # run the step N times
     "repeat_settings": [..],       # per-repeat settings_key overrides
     "param_override": {...},       # inline parameter overrides
     "enabled": true}

Each step consumes/produces named artifacts (geometries, paths, TS guesses)
in a shared context dict, mirroring the reference's path merging (:843),
candidate selection (:877), and TS consolidation (:935). Steps chain through
tensors on the calculator's device — no files.
"""

import json
from typing import Any, Dict, List

import numpy as np
import torch

from multioptpy_tpu_torch.device import on_device, resolve_device


class WorkflowError(ValueError):
    pass


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# the reference's v2 configs name steps after its _run_stepN methods
# (ref: Wrapper/autots.py:570 hasattr(self, f"_run_{step_name}"),
# test/config_autots_v2_test.json)
REF_STEP_ALIASES = {"step1": "afir", "step2": "neb",
                    "step3": "saddle", "step4": "irc"}


def validate_workflow(workflow_steps):
    """ref: autots.py _validate_workflow_config."""
    known = {"afir", "opt", "neb", "saddle", "irc", "freq", "confsearch"} \
        | set(REF_STEP_ALIASES)
    for i, entry in enumerate(workflow_steps):
        name = entry.get("step")
        if name not in known:
            raise WorkflowError(f"workflow entry {i}: unknown step '{name}'")
        repeat = entry.get("repeat", 1)
        if not isinstance(repeat, int) or repeat < 1:
            raise WorkflowError(
                f"workflow entry {i} ({name}): 'repeat' must be a positive "
                "integer")
        rs = entry.get("repeat_settings", [])
        if rs and len(rs) > repeat:
            raise WorkflowError(
                f"workflow entry {i} ({name}): 'repeat_settings' longer "
                "than 'repeat'")
    return True


class AutoTSv2:
    """Execute a v2 workflow config against one input structure.
    `stage_hook(name, report=..., result=...)`, if given, is called after
    each step with its report and its result (the NEB, optimizer or IRC
    result; the normal modes of a freq step)."""

    def __init__(self, calc, coords, z, config, device=None,
                 stage_hook=None):
        self.calc = calc
        self.stage_hook = stage_hook
        self.result = None
        self.dev = resolve_device(device)
        self.z = np.asarray(z)
        self.config = dict(config)
        self.steps = self.config.get("workflow", [])
        validate_workflow(self.steps)
        # shared artifact context (ref: v2 path merging / candidate lists)
        self.ctx: Dict[str, Any] = {
            "geometry": on_device(coords, self.dev),
            "product": None,
            "path": None,
            "ts_guess": None,
            "ts": None,
            "irc_ends": None,
            "history": [],
        }

    # ---- settings resolution (ref: _get_settings_for_repeat) -------------

    def _settings(self, entry, repeat_index):
        key = entry.get("settings_key", f"{entry['step']}_settings")
        rs = entry.get("repeat_settings", [])
        if rs and repeat_index < len(rs):
            rep = rs[repeat_index]
            if isinstance(rep, str):
                key = rep
        settings = dict(self.config.get(key, {}))
        rep_over = {}
        if rs and repeat_index < len(rs) and isinstance(rs[repeat_index],
                                                       dict):
            rep_over = dict(rs[repeat_index].get("param_override", {}))
        settings.update(entry.get("param_override", {}))
        settings.update(rep_over)
        return self._normalize(settings)

    @staticmethod
    def _normalize(s):
        """Reference argparse dest names -> engine keys. The reference's
        v2 configs reuse the stepN_settings vocabulary of interface.py
        (test/config_autots_v2_test.json: opt_method, NSTEP,
        manual_AFIR, calc_exact_hess, ...); native engine keys win when
        both are present."""
        out = dict(s)
        om = out.get("opt_method")
        if om:
            om = [om] if isinstance(om, str) else list(om)
            out.setdefault("method", om[-1])
        if "NSTEP" in out:
            out.setdefault("nsteps", int(out["NSTEP"]))
        fc = int(out.get("calc_exact_hess", -1) or -1)
        if fc > 0:
            out.setdefault("fc_count", fc)
        ma = out.get("manual_AFIR")
        if ma:
            from multioptpy_tpu_torch.workflows.autots import _v1_afir_list
            triples = _v1_afir_list(ma)
            if triples:
                out.setdefault("gamma", triples[0][0])
                out.setdefault("fragm_1", list(triples[0][1]))
                out.setdefault("fragm_2", list(triples[0][2]))
                out.setdefault("afir_list", triples)
        if out.get("max_trust_radius") is not None:
            out.setdefault("trust_radius", float(out["max_trust_radius"]))
        from multioptpy_tpu_torch.workflows.autots import _V1_VARIANTS
        for dest, variant in _V1_VARIANTS:
            if out.get(dest):
                out.setdefault("variant", variant)
                break
        ics = out.get("intrinsic_reaction_coordinates")
        if ics:
            # [step_size, n_steps, method] (ref: optimization.py:2173);
            # IRC-specific keys so they don't clash with opt_method/NSTEP
            # living in the same step4 settings block
            if len(ics) > 0:
                out.setdefault("step_size", float(ics[0]))
            if len(ics) > 1:
                out.setdefault("irc_nsteps", int(ics[1]))
            if len(ics) > 2:
                out.setdefault("irc_method", str(ics[2]))
        return out

    def _opt_cfg(self, s, **defaults):
        """OptimizeConfig from engine keys layered over reference dest
        names (use_model_hessian, tight/loose criteria, trust radii)."""
        from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig
        from multioptpy_tpu_torch.workflows.autots import _v1_opt_config

        kw = dict(defaults)
        for key in ("method", "nsteps", "fc_count", "saddle_order"):
            if key in s:
                kw[key] = s[key]
        if "trust_radius" in s:
            kw["trust_radius_ang"] = s["trust_radius"]
        return _v1_opt_config(s, OptimizeConfig(**kw))

    # ---- step implementations -------------------------------------------

    def _step_afir(self, s):
        from multioptpy_tpu_torch.drivers.optimize import optimize
        from multioptpy_tpu_torch.potentials import BiasEngine, get_potential

        triples = s.get("afir_list") or [(s.get("gamma", 150.0),
                                          s.get("fragm_1", [1]),
                                          s.get("fragm_2", [2]))]
        bias = BiasEngine([get_potential(
            "afir", gamma=g, fragm_1=list(f1), fragm_2=list(f2),
            element_z=self.z) for (g, f1, f2) in triples])
        res = optimize(self.calc, self.ctx["geometry"], self.z,
                       bias_engine=bias,
                       config=self._opt_cfg(s, method="rfo_fsb",
                                            nsteps=300, fc_count=10),
                       record_trajectory=True, device=self.dev)
        self.ctx["product"] = res.coords
        self.ctx["path"] = on_device(res.coords_history, self.dev)
        self.result = res
        return {"energy": float(res.energy)}

    def _step_opt(self, s):
        from multioptpy_tpu_torch.drivers.optimize import optimize

        target = s.get("target", "geometry")
        res = optimize(self.calc, self.ctx[target], self.z,
                       config=self._opt_cfg(s, method="rfo_fsb",
                                            nsteps=200), device=self.dev)
        self.ctx[target] = res.coords
        self.result = res
        return {"energy": float(res.energy), "converged": bool(res.converged)}

    def _step_neb(self, s):
        from multioptpy_tpu_torch.drivers.neb import (
            NEBConfig, idpp_path, interpolate_linear, neb)
        from multioptpy_tpu_torch.interpolation import linear_resample

        n_images = s.get("n_images", 12)
        nd = next((float(s[k]) for k in
                   ("node_distance", "node_distance_spline",
                    "node_distance_bernstein") if s.get(k) is not None),
                  None)
        if nd is not None:
            # image count from source-path arc length (ref: -nd family,
            # interface.py:284-287)
            from multioptpy_tpu_torch.units import BOHR2ANGSTROM
            if self.ctx.get("path") is not None and s.get("from_path", True):
                src = _host(self.ctx["path"])
            else:
                src = np.stack([_host(self.ctx["geometry"]),
                                _host(self.ctx["product"])])
            seg = np.sqrt(((src[1:] - src[:-1]) ** 2).sum(axis=(1, 2)))
            n_images = int(np.clip(
                round(float(seg.sum()) * BOHR2ANGSTROM / nd) + 1, 4, 64))
        if self.ctx.get("path") is not None and s.get("from_path", True):
            path0 = linear_resample(self.ctx["path"], n_images)
        else:
            if self.ctx.get("product") is None:
                raise WorkflowError("neb step needs a product or a path")
            fn = idpp_path if s.get("idpp", False) else interpolate_linear
            path0 = fn(self.ctx["geometry"], self.ctx["product"], n_images)
        # in-loop redistribution from the reference's -ad* dest names
        # (ref: interface.py:267-287)
        from multioptpy_tpu_torch.workflows.autots import _V1_REDIST
        redist, every = s.get("redistribute", ""), s.get(
            "redistribute_every", 0)
        if not redist:
            for dest, scheme in _V1_REDIST:
                n_every = int(s.get(dest, 0) or 0)
                if n_every > 0:
                    redist, every = scheme, n_every
        res = neb(self.calc, path0, self.z, NEBConfig(
            variant=s.get("variant", "cineb"),
            n_steps=s.get("nsteps", 200),
            k_spring=s.get("k_spring", 0.01),
            climbing_start=s.get("climbing_start", 30),
            redistribute=redist, redistribute_every=every), device=self.dev)
        self.ctx["path"] = res.path
        self.ctx["ts_guess"] = res.path[res.ts_index]
        self.result = res
        return {"ts_index": res.ts_index,
                "e_max": float(res.energies[res.ts_index])}

    def _step_saddle(self, s):
        from multioptpy_tpu_torch.workflows.autots import refine_saddle

        if self.ctx.get("ts_guess") is None:
            raise WorkflowError("saddle step needs a ts_guess (run neb first)")
        res = refine_saddle(self.calc, self.ctx["ts_guess"], self.z,
                            self._opt_cfg(s, method="rfo_bofill",
                                          saddle_order=1, nsteps=100,
                                          fc_count=5, init_hessian="exact",
                                          trust_radius_ang=s.get(
                                              "trust_radius", 0.1)),
                            device=self.dev)
        self.ctx["ts"] = res.coords
        self.result = res
        report = {"energy": float(res.energy),
                  "converged": bool(res.converged)}
        if s.get("frequency_analysis"):
            # ref step3 frequency_analysis: validate curvature in place
            report.update(self._step_freq({}))
        return report

    def _step_freq(self, s):
        from multioptpy_tpu_torch.analysis.vibrations import (count_imaginary,
                                                              normal_modes)
        from multioptpy_tpu_torch.ops import hosteval

        target = self.ctx.get("ts") if self.ctx.get("ts") is not None \
            else self.ctx["geometry"]
        h = hosteval.hessian(self.calc, target[None], self.z)[0]
        nm = normal_modes(h, target, self.z)
        n_imag = count_imaginary(nm.frequencies_cm1)
        self.result = nm
        return {"n_imaginary": n_imag,
                "lowest_cm1": float(nm.frequencies_cm1[0])}

    def _step_irc(self, s):
        from multioptpy_tpu_torch.drivers.irc import IRCConfig, irc

        if self.ctx.get("ts") is None:
            raise WorkflowError("irc step needs a refined ts")
        res = irc(self.calc, self.ctx["ts"], self.z, config=IRCConfig(
            method=s.get("irc_method", s.get("method", "lqa")),
            step_size=s.get("step_size", 0.05),
            n_steps=s.get("irc_nsteps", s.get("nsteps", 150))),
                  device=self.dev)
        self.result = res
        ends = [on_device(res.forward_path[-1], self.dev),
                on_device(res.backward_path[-1], self.dev)]
        report = {"ts_energy": res.ts_energy}
        ep = s.get("step4b_opt_method")
        if ep:
            # ref step4b: relax both IRC endpoints with their own
            # optimizer (Wrapper/autots.py step4b)
            from multioptpy_tpu_torch.drivers.optimize import optimize
            cfg = self._opt_cfg({"opt_method": ep}, method="rfo_fsb",
                                nsteps=200)
            opts = [optimize(self.calc, e, self.z, config=cfg,
                             device=self.dev) for e in ends]
            ends = [o.coords for o in opts]
            report["endpoint_energies"] = [float(o.energy) for o in opts]
        self.ctx["irc_ends"] = tuple(ends)
        return report

    def _step_confsearch(self, s):
        from multioptpy_tpu_torch.workflows.confsearch import (
            ConfSearchConfig, conformer_search)

        res = conformer_search(self.calc, self.ctx["geometry"], self.z,
                               ConfSearchConfig(
                                   n_rounds=s.get("n_rounds", 4),
                                   batch_size=s.get("batch_size", 8),
                                   base_gamma=s.get("base_gamma", 150.0)),
                               device=self.dev)
        self.ctx["geometry"] = on_device(res.conformers[0], self.dev)
        self.result = res
        return {"n_conformers": len(res.energies),
                "best_energy": float(res.energies[0])}

    # ---- engine ----------------------------------------------------------

    def run(self):
        """ref: autots.py run_dynamic_workflow. Returns the step report
        list; artifacts live in self.ctx."""
        dispatch = {"afir": self._step_afir, "opt": self._step_opt,
                    "neb": self._step_neb, "saddle": self._step_saddle,
                    "irc": self._step_irc, "freq": self._step_freq,
                    "confsearch": self._step_confsearch}
        reports: List[dict] = []
        for entry in self.steps:
            if not entry.get("enabled", True):
                continue
            name = REF_STEP_ALIASES.get(entry["step"], entry["step"])
            for rep in range(entry.get("repeat", 1)):
                s = self._settings(entry, rep)
                self.result = None
                out = dispatch[name](s)
                report = {"step": name, "repeat": rep, **out}
                reports.append(report)
                self.ctx["history"].append(report)
                if self.stage_hook is not None:
                    self.stage_hook(name, report=report, result=self.result)
        return reports


def run_autots_v2(calc, coords, z, config_path_or_dict,
                  product_coords=None, device=None, stage_hook=None):
    """Convenience loader (ref: Entrypoints/autots.py:29 config load,
    :70 v1/v2 select by presence of a 'workflow' block).
    `product_coords` seeds ctx['product'] so a workflow starting at step2
    (NEB) has its second endpoint. `device` (None means the CUDA card)
    is where every step runs; `stage_hook` goes to `AutoTSv2`."""
    if isinstance(config_path_or_dict, str):
        with open(config_path_or_dict) as f:
            config = json.load(f)
    else:
        config = config_path_or_dict
    engine = AutoTSv2(calc, coords, z, config, device=device,
                      stage_hook=stage_hook)
    if product_coords is not None:
        engine.ctx["product"] = on_device(product_coords, engine.dev)
    reports = engine.run()
    return engine, reports
