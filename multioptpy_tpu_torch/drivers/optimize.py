"""Geometry-optimization driver: batched state + one step function.

Counterpart of `multioptpy_tpu/drivers/optimize.py`, every method and
option. The reference's step is one jitted program `vmap`ped over
structures; here the state carries an explicit leading batch axis (on every
field, engine states included) and the step is a plain function over it:
biased energy/gradient, TR/rot and constraint projection, then one engine --

* quasi-Newton (`rfo_*`, `prfo_*`, their aliases): rank-2 or block Hessian
  updates, periodic exact and model Hessians, RS-RFO, RS-P-RFO, mode
  following (`mf_`), mass weighting (`mw`), the constrained null-space
  solve (`crsirfo`), TRIM (`_trim`) and the six DIIS variants;
* delocalized internal coordinates (`dic_rsirfo_*`);
* first-order: FIRE, FIRE2, ABC-FIRE, CG, L-BFGS (and TR-L-BFGS), SD,
  mass-weighted SD, Eve, Adam/AdaBelief/RAdam, GAN, RL and GP (`gpmin`);

with the sigmoid RMS-force blend toward a first-order engine
(`switch_method`), SHAKE back onto the constraints, convergence masking
(converged members are frozen) and, for minimizations, uphill-step
rejection with a measured-curvature BFGS update. Where the reference
branches per structure (`lax.cond`, `jnp.where`) the port selects per row.

* `optimize()` -- host loop on one structure with early exit, constraints,
  shape conditions, -negeigval and checkpoints; with `config.scan_chunk >
  1` the chunked semantics of the reference's `_optimize_chunked`.
* `optimize_batch()` -- a fixed number of steps over a batch (a Python loop
  in place of the reference's `lax.scan`).

Convergence semantics are the reference's (Gaussian-style 4 criteria with
force-coupled displacement thresholds, masked RMS).
"""

import contextlib
import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from multioptpy_tpu_torch.coords.internals import (auto_internals,
                                                   detect_primitives)
from multioptpy_tpu_torch.device import (bmv, calc_device, on_device,
                                         resolve_device)
from multioptpy_tpu_torch.geometry import (judge_shape_condition,
                                           masses_from_z,
                                           project_gradient_tr_rot,
                                           project_hessian_tr_rot,
                                           tr_rot_projector)
from multioptpy_tpu_torch.hessian.block_updates import (block_update_hessian,
                                                        block_window_init)
from multioptpy_tpu_torch.hessian.model import (make_model_hessian_fn,
                                                model_hessian)
from multioptpy_tpu_torch.hessian.updates import auto_scale, update_hessian
from multioptpy_tpu_torch.logging_utils import (count, count_members,
                                                host_read, recording, span,
                                                spanned)
from multioptpy_tpu_torch.ops import hosteval
from multioptpy_tpu_torch.steppers import diis, gp, learned, ml
from multioptpy_tpu_torch.steppers.enhancements import (
    mode_following_direction, trim_step)
from multioptpy_tpu_torch.steppers.first_order import (
    abc_fire_step, cg_init, cg_step, fire2_step, fire_init, fire_step,
    lbfgs_init, lbfgs_step, mwsd_step, sd_step)
from multioptpy_tpu_torch.steppers.rfo import (rs_prfo_step, rs_rfo_step,
                                               update_trust_radius)
from multioptpy_tpu_torch.units import ANGSTROM2BOHR

_FIRE = {"fire": fire_step, "fire2": fire2_step, "abc_fire": abc_fire_step}


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    """Driver configuration (defaults = reference defaults); the same fields
    as the reference."""

    method: str = "rfo_fsb"
    nsteps: int = 1000
    saddle_order: int = 0
    max_force: float = 3e-4          # Hartree/Bohr
    rms_force: float = 2e-4
    max_displacement: float = 1.5e-3  # Bohr
    rms_displacement: float = 1e-3
    trust_radius_ang: Optional[float] = None  # default 0.5 (min) / 0.1 (saddle)
    trust_radius_min_ang: float = 0.01
    delta: float = 1.0               # first-order step scale
    fc_count: int = -1               # exact Hessian every k steps (-1: never)
    mfc_count: int = -1              # model-Hessian rebuild cadence
    init_hessian: str = "auto"       # auto | exact | identity | model:<kind>
    use_gdiis: bool = False
    diis_variant: Optional[str] = None  # gdiis | gediis | kdiis | ediis |
                                     # adiis | c2diis (overrides use_gdiis)
    follow_mode_index: int = 0       # initial mode of mf_rsirfo_* methods
    # the step's eigensolver knob (ops/eigh64.plan)
    eigh_impl: str = "xla"
    switch_method: Optional[str] = None  # first-order engine blended in at
                                     # high RMS force (CLI: -opt m1 m2)
    project_tr_rot: bool = True
    scan_chunk: int = 0

    def effective_diis(self):
        return self.diis_variant or ("gdiis" if self.use_gdiis else None)

    def initial_trust_bohr(self):
        tr = self.trust_radius_ang
        if tr is None:
            tr = 0.1 if self.saddle_order > 0 else 0.5
        return tr * ANGSTROM2BOHR

    def criteria(self, tight=False, loose=False):
        if tight:
            return (1.5e-5, 1e-5, 6e-5, 4e-5)
        if loose:
            return (3e-3, 2e-3, 1e-2, 7e-3)
        return (self.max_force, self.rms_force,
                self.max_displacement, self.rms_displacement)


class OptState(NamedTuple):
    """Batched optimizer state; every field has a leading batch axis B, and
    so does every tensor of `fo_state` (the engines' states, in the
    reference's slot order)."""

    coords: torch.Tensor        # (B,N,3) Bohr
    energy: torch.Tensor        # (B,)
    gradient: torch.Tensor      # (B,N,3) effective gradient
    raw_gradient: torch.Tensor  # (B,N,3) unbiased gradient
    prev_coords: torch.Tensor
    prev_energy: torch.Tensor
    prev_raw_gradient: torch.Tensor
    hessian: torch.Tensor       # (B,3N,3N)
    trust_radius: torch.Tensor  # (B,) Bohr
    predicted_change: torch.Tensor
    move: torch.Tensor          # (B,N,3) last displacement
    iteration: torch.Tensor     # (B,) int32
    converged: torch.Tensor     # (B,) bool
    fo_state: tuple = ()


def tree_map(fn, *trees):
    """fn over the tensor leaves of matching trees (NamedTuples, tuples,
    lists); any other leaf (a generator) is taken from the first tree."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return first


def _select(cond, a, b):
    """Leafwise where(cond, a, b) over two state trees, cond (B,)."""
    def pick(x, y):
        return torch.where(cond.reshape(-1, *([1] * (x.ndim - 1))), x, y)
    return tree_map(pick, a, b)


def _batched(tree, b):
    """An unbatched engine state with a leading batch axis of b rows."""
    return tree_map(lambda x: x.expand(b, *x.shape).clone(), tree)


def _masked_rms(v, thresh=1e-10):
    """RMS over components with |v| > thresh, per row of (B, D)."""
    mask = v.abs() > thresh
    n = mask.sum(-1)
    s = torch.where(mask, v * v, 0.0).sum(-1)
    return torch.sqrt(s / n.clamp(min=1))


def check_convergence(gradient, displacement, criteria):
    """Four Gaussian-style criteria with force-coupled displacement
    thresholds, per structure: (B, ...) inputs -> (B,) bool."""
    max_f_th, rms_f_th, max_d_th, rms_d_th = criteria
    g = gradient.reshape(gradient.shape[0], -1)
    d = displacement.reshape(displacement.shape[0], -1)
    max_force = g.abs().amax(-1)
    rms_force = _masked_rms(g)
    max_disp = d.abs().amax(-1)
    rms_disp = _masked_rms(d)
    d_max_th = max_d_th + torch.clamp(max_f_th - max_force, min=0.0)
    d_rms_th = rms_d_th + torch.clamp(rms_f_th - rms_force, min=0.0)
    return ((max_force < max_f_th) & (rms_force < rms_f_th)
            & (max_disp < d_max_th) & (rms_disp < d_rms_th))


def _parse_method(method):
    """-> (kind, sub): the engine and its update rule or variant, for every
    method string of the reference (aliases, `_trim`, the `mw`/`mwmf`/`mws`
    prefixes, `crsirfo`, `dic_rsirfo`, `smf_`/`mf_`). The flags those
    prefixes set (mw, mf, crs, dic, trim) are read off the method string by
    `init_state` and `make_step_fn`."""
    m = method.lower()
    m = m.replace("_trim", "")
    for prefix, engine in (("dic_rsirfo", "rfo"), ("crsirfo", "rfo"),
                           ("smf_rsirfo", "prfo"), ("mf_rsirfo", "prfo"),
                           ("rsirfo", "rfo"), ("rsprfo", "prfo")):
        if m.startswith(prefix):
            m = engine + m[len(prefix):]
    if m.startswith("prfo"):
        return ("prfo", m.split("_", 1)[1] if "_" in m else "auto")
    if m.startswith("rfo"):
        return ("rfo", m.split("_", 1)[1] if "_" in m else "auto")
    if m.startswith("cg"):
        return ("cg", m.split("_", 1)[1] if "_" in m else "pr")
    if m == "tr_lbfgs":
        return ("lbfgs", "tr")
    if m in ("fire", "fire2", "abc_fire", "lbfgs", "sd", "eve", "gan", "rl",
             "mwsd", "gpmin"):
        return (m, None)
    if m.startswith("mw"):
        return _parse_method(m[2:])
    if m in ml.OPTAX_STEPPERS:
        return ("optax", m)
    raise ValueError(f"unknown optimization method '{method}'")


def _is_mf(method):
    return method.lower().replace("mw", "", 1).startswith("mf_rsirfo")


def _dic_diag_hessian(ic, dtype, device=None):
    """Baker-style diagonal primitive-space guess: 0.5 / 0.2 / 0.1 Hartree
    per Bohr^2/rad^2 for stretches/bends/torsions, 0.2 for linear bends."""
    nb, na, nt = len(ic.bonds), len(ic.angles), len(ic.torsions)
    nl = 2 * len(ic.linear_bends)
    return torch.diag(torch.as_tensor(
        np.concatenate([np.full(nb, 0.5), np.full(na, 0.2),
                        np.full(nt, 0.1), np.full(nl, 0.2)]), dtype=dtype,
        device=device))


def _masses3(z, dtype, device):
    return torch.repeat_interleave(
        masses_from_z(np.asarray(z)).to(dtype=dtype, device=device), 3)


@spanned("init")
def init_state(coords, z, calc, bias_engine=None, config=OptimizeConfig(),
               hessian0=None, internals=None):
    """The initial batched OptState of coords (B,N,3): one energy/gradient
    evaluation, the initial Hessian the config asks for (quasi-Newton `rfo`
    engines; identity for the others) and every engine's state in the
    reference's `fo_state` order. `internals` (InternalCoordinates) puts a
    `dic_*` method's quasi-Newton state in primitive space."""
    b, n, _ = coords.shape
    dtype, dev = coords.dtype, coords.device
    n3 = 3 * n
    e, g, raw_g = hosteval.eg_with_raw(calc, coords, z, bias_engine)
    eye = torch.eye(n3, dtype=dtype, device=dev)
    kind, sub = _parse_method(config.method)
    if hessian0 is None:
        use_exact = (config.init_hessian == "exact"
                     or (config.init_hessian == "auto" and calc.on_device))
        if kind != "rfo":
            hessian0 = eye
        elif config.init_hessian.startswith("model:"):
            hessian0 = model_hessian(
                coords, z, kind=config.init_hessian.split(":", 1)[1],
                gradient=raw_g)
        elif use_exact:
            hessian0 = hosteval.hessian(calc, coords, z, bias_engine)
        else:
            hessian0 = eye
    hessian0 = torch.as_tensor(hessian0, dtype=dtype, device=dev).expand(
        b, -1, -1).clone()

    kw = dict(dtype=dtype, device=dev)
    if kind in _FIRE:
        fo = (fire_init(n3, **kw),)
    elif kind == "lbfgs":
        fo = (lbfgs_init(n3, **kw),)
    elif kind == "cg":
        fo = (cg_init(n3, **kw),)
    elif kind == "eve":
        fo = (ml.eve_init(n3, **kw),)
    elif kind == "gan":
        fo = (learned.gan_init(n3, **kw),)
    elif kind == "rl":
        fo = (learned.rl_init(n3, **kw),)
    elif kind == "gpmin":
        _, n_feat = gp.inv_dist_descriptor(n)
        fo = (gp.gp_init(n_feat, **kw),)
    elif kind == "optax":
        fo = (ml.optax_init(sub, n3, **kw),)
    elif kind in ("rfo", "prfo") and sub.startswith("block"):
        fo = (block_window_init(n3, **kw),)
    else:
        fo = ()
    fo = _batched(fo, b)
    if internals is not None and config.method.lower().startswith("dic"):
        # q-space quasi-Newton state: primitive Hessian, previous q-space
        # gradient and values
        q0 = internals.q_flat(coords.reshape(b, n3))
        b0 = internals.b_matrix(coords)
        g_q0 = bmv(internals.g_pinv(internals.g_matrix(b0)),
                   bmv(b0, g.reshape(b, n3)))
        fo = fo + (_dic_diag_hessian(internals, dtype, dev).expand(
            b, -1, -1).clone(), g_q0, q0)
    if _is_mf(config.method):
        mode0, _ = mode_following_direction(hessian0,
                                            index=config.follow_mode_index)
        fo = fo + (mode0,)
    dv = config.effective_diis()
    if kind in ("rfo", "prfo") and dv and not \
            config.method.lower().startswith("dic"):
        ini = {"gdiis": diis.diis_init, "gediis": diis.gediis_init,
               "kdiis": diis.kdiis_init, "ediis": diis.gediis_init,
               "adiis": diis.gediis_init, "c2diis": diis.gediis_init}[dv]
        fo = fo + (_batched(ini(n3, **kw), b),)
    if config.switch_method:
        # the high-force first-order engine's slot is the last one
        if dv:
            raise ValueError("switch_method does not compose with DIIS")
        sk, _ = _parse_method(config.switch_method)
        if sk in _FIRE:
            fo = fo + (_batched(fire_init(n3, **kw), b),)
        elif sk in ("sd", "mwsd"):
            fo = fo + (torch.zeros((b, 0), **kw),)   # stateless placeholder
        else:
            raise ValueError("switch_method must be a first-order engine "
                             "(fire/fire2/abc_fire/sd/mwsd)")

    return OptState(
        coords=coords, energy=e, gradient=g, raw_gradient=raw_g,
        prev_coords=coords, prev_energy=e, prev_raw_gradient=raw_g,
        hessian=hessian0,
        trust_radius=torch.full((b,), config.initial_trust_bohr(), **kw),
        predicted_change=torch.zeros(b, **kw),
        move=torch.zeros_like(coords),
        iteration=torch.zeros(b, dtype=torch.int32, device=dev),
        converged=torch.zeros(b, dtype=torch.bool, device=dev),
        fo_state=fo)


_STATE_FLOATS = ("coords", "energy", "gradient", "raw_gradient",
                 "prev_coords", "prev_energy", "prev_raw_gradient", "hessian",
                 "trust_radius", "predicted_change", "move")


def _fo_from_numpy(node, batched, dev):
    """The reference's engine-state tree (numpy leaves, its NamedTuple
    classes) as the port's: classes matched by name, a batch axis added
    when the reference state was one structure's. The reference's optax
    state (inner = (ScaleBy*State, EmptyState)) becomes OptaxState; the
    RL key becomes a generator seeded from it."""
    from multioptpy_tpu_torch.checkpoint import state_types

    if isinstance(node, tuple) and hasattr(node, "_fields"):
        name = type(node).__name__
        if name == "OptaxState" and "inner" in node._fields:
            node = node.inner[0]
        fields = {}
        for f in node._fields:
            val = getattr(node, f)
            if name == "RlState" and f == "key":
                seed = int(np.asarray(val).astype(np.uint64).ravel()[-1])
                fields[f] = torch.Generator(device=dev).manual_seed(seed)
            else:
                fields[f] = _fo_from_numpy(val, batched, dev)
        cls = ml.OptaxState if name == "OptaxState" else state_types()[name]
        return cls(**fields)
    if isinstance(node, (tuple, list)):
        return type(node)(_fo_from_numpy(x, batched, dev) for x in node)
    x = torch.as_tensor(np.array(node), device=dev)
    return x if batched else x[None]


def state_from_numpy(fields, device=None):
    """An OptState from numpy fields named as the reference's OptState
    (coords, energy, gradient, ..., iteration, converged, fo_state).
    Unbatched fields (coords (N,3)) get a batch axis of one; `fo_state` is
    the reference's engine-state tree."""
    dev = resolve_device(device)
    coords = np.asarray(fields["coords"])
    batched = coords.ndim == 3
    dtype = torch.float64 if coords.dtype == np.float64 else torch.float32

    def conv(name, tdtype):
        x = torch.as_tensor(np.array(fields[name]), dtype=tdtype,
                            device=dev)
        return x if batched else x[None]

    return OptState(**{k: conv(k, dtype) for k in _STATE_FLOATS},
                    iteration=conv("iteration", torch.int32),
                    converged=conv("converged", torch.bool),
                    fo_state=_fo_from_numpy(tuple(fields.get("fo_state", ())),
                                            batched, dev))


def make_step_fn(calc, z, bias_engine=None, config=OptimizeConfig(),
                 model_hessian_fn=None, constraints=None,
                 constraint_targets=None, internals=None):
    """Build the batched `state -> state` transition. `model_hessian_fn(
    coords, raw_gradient)` rebuilds the Hessian every `config.mfc_count`
    steps; `constraints` (with their (B, K) `constraint_targets`) project
    gradient, Hessian and step and SHAKE the geometry; `internals` runs a
    `dic_*` method in delocalized internals."""
    kind, sub = _parse_method(config.method)
    method = config.method.lower()
    is_dic = internals is not None and method.startswith("dic")
    if is_dic and sub.startswith("block"):
        raise ValueError("dic_rsirfo does not compose with block updates")
    is_mw = method.startswith("mw")
    is_mf = _is_mf(config.method)
    is_crs = method.startswith("crsirfo")
    is_trim = "trim" in method
    dv = config.effective_diis()
    constrained = constraints is not None and constraints.has_any()
    criteria = config.criteria()
    saddle_order = config.saddle_order
    tr_max = config.initial_trust_bohr()
    tr_min = config.trust_radius_min_ang * ANGSTROM2BOHR

    def new_trust(state):
        """Trust-radius feedback from the previous step's prediction."""
        trust = update_trust_radius(
            state.trust_radius, state.energy - state.prev_energy,
            state.predicted_change, tr_min=tr_min, tr_max=tr_max)
        return torch.where(state.iteration > 0, trust, state.trust_radius)

    def rebuild_rows(h, state, every, build):
        """h with the rows due at this cadence rebuilt by build(idx)."""
        rebuild = (state.iteration % every) == 0
        if bool(rebuild.any()):
            idx = rebuild.nonzero()[:, 0]
            h = h.clone()
            h[idx] = build(idx)
        return h

    def exact_hessian(coords):
        return hosteval.hessian(calc, coords, z, bias_engine)

    def dic_move(state, g_flat):
        """RS-I-RFO in delocalized internals: primitive-space quasi-Newton
        Hessian, RFO in the Baker active space U (nonzero eigenvectors of
        G = B B^T; `torch.linalg.eigh` for the step), Gauss-Newton
        back-transform; a failed back-transform falls back to the
        trust-clipped projected gradient."""
        ic = internals
        coords = state.coords
        b = coords.shape[0]
        q_now = ic.q_flat(coords.reshape(b, -1))
        bm = ic.b_matrix(coords)
        g_q = bmv(ic.g_pinv(ic.g_matrix(bm)), bmv(bm, g_flat))
        h_q, g_q_prev, q_prev = state.fo_state
        with span("step.update"):
            s_q = q_now - q_prev
            s_q = torch.where(ic.torsion_mask(coords.device),
                              torch.atan2(torch.sin(s_q), torch.cos(s_q)),
                              s_q)
            have_pair = (state.iteration > 0) & (
                torch.linalg.vector_norm(s_q, dim=-1) > 1e-12)
            h_q = torch.where(have_pair[:, None, None],
                              update_hessian(h_q, s_q, g_q - g_q_prev, sub),
                              h_q)
            if config.fc_count > 0 and calc.on_device:
                h_q = rebuild_rows(h_q, state, config.fc_count, lambda idx: (
                    ic.internal_hessian_from_cart(
                        exact_hessian(coords[idx]), g_flat[idx].reshape(
                            len(idx), -1, 3), coords[idx])))

        u, keep = ic.delocalized_basis(coords)
        g_u = bmv(u.mT, g_q) * keep
        h_u = u.mT @ h_q @ u
        h_u = 0.5 * (h_u + h_u.mT) + torch.diag_embed((~keep).to(g_flat.dtype))
        trust_new = new_trust(state)
        step_u, aux = rs_rfo_step(g_u, h_u, trust_new,
                                  saddle_order=saddle_order)
        x_new = ic.to_cartesian(q_now + bmv(u, step_u),
                                coords)
        mv = (x_new - coords).reshape(b, -1)
        ok = (torch.isfinite(mv).all(-1)
              & (torch.linalg.vector_norm(mv, dim=-1) < 10.0 * trust_new
                 + 1e-2))
        sd = -g_flat
        sd_n = torch.linalg.vector_norm(sd, dim=-1)
        sd = torch.where((sd_n > trust_new)[:, None],
                         sd * (trust_new / sd_n.clamp(min=1e-30))[:, None],
                         sd)
        mv = torch.where(ok[:, None], mv, sd)
        return (mv, state.hessian, trust_new,
                aux["predicted_energy_change"], (h_q, g_q, q_now))

    def quasi_newton_move(state, g_flat):
        b, n3 = g_flat.shape
        eye = torch.eye(n3, dtype=g_flat.dtype, device=g_flat.device)
        with span("step.update"):
            s = (state.coords - state.prev_coords).reshape(b, -1)
            y = (state.raw_gradient - state.prev_raw_gradient).reshape(b, -1)
            have_pair = (state.iteration > 0) & (
                torch.linalg.vector_norm(s, dim=-1) > 1e-12)
            is_identity = (state.hessian == eye).all(-1).all(-1)
            h = auto_scale(state.hessian, s, y, is_identity & have_pair)
            if sub.startswith("block"):
                win = state.fo_state[0]
                h_upd, win_new = block_update_hessian(h, win, s, y, sub)
                h = torch.where(have_pair[:, None, None], h_upd, h)
                qn_fo = (_select(have_pair, win_new, win),)
            else:
                h = torch.where(have_pair[:, None, None],
                                update_hessian(h, s, y, sub), h)
                qn_fo = ()
            if config.fc_count > 0 and calc.on_device:
                h = rebuild_rows(h, state, config.fc_count,
                                 lambda idx: exact_hessian(state.coords[idx]))
            if config.mfc_count > 0 and model_hessian_fn is not None:
                h = rebuild_rows(h, state, config.mfc_count,
                                 lambda idx: model_hessian_fn(
                                     state.coords[idx],
                                     state.raw_gradient[idx]))

        # TR/rot-projected effective Hessian, the projected-out subspace
        # shifted to +1e3 so it can never be chosen as a saddle mode
        with span("step.project"):
            if config.project_tr_rot and state.coords.shape[1] > 1:
                p = tr_rot_projector(state.coords)
                h_eff = p.mT @ h @ p
                h_eff = 0.5 * (h_eff + h_eff.mT) + 1e3 * (eye - p)
            else:
                h_eff = h
            if constrained:
                h_eff = constraints.project_hessian(h_eff, state.coords)
        return quasi_newton_solve(state, g_flat, h, h_eff, qn_fo)

    @spanned("step.solve")
    def quasi_newton_solve(state, g_flat, h, h_eff, qn_fo):
        b = g_flat.shape[0]
        trust_new = new_trust(state)
        if is_mw:
            # the step in M^1/2-scaled coordinates, scaled back below
            minv = 1.0 / torch.sqrt(_masses3(z, g_flat.dtype, g_flat.device))
            g_flat = g_flat * minv
            h_eff = h_eff * minv[:, None] * minv[None, :]

        if kind == "prfo" and is_mf:
            # maximize along the eigenvector overlapping the carried mode,
            # then carry that (sign-aligned) eigenvector forward
            mode = state.fo_state[1 if sub.startswith("block") else 0]
            step, aux = rs_prfo_step(g_flat, h_eff, trust_new,
                                     follow_vector=mode,
                                     eigh_impl=config.eigh_impl)
            qn_fo = qn_fo + (aux["followed_mode"],)
        elif kind == "prfo":
            step, aux = rs_prfo_step(g_flat, h_eff, trust_new,
                                     saddle_order=max(saddle_order, 1),
                                     eigh_impl=config.eigh_impl)
        elif is_crs and constraints is not None and constraints.n_constraints:
            # null space of the constraint Jacobian by SVD, RS-RFO in it,
            # the step lifted back (SHAKE below restores the constraints)
            bj = constraints.jacobian(state.coords)           # (B, m, 3N)
            q = torch.linalg.svd(bj, full_matrices=True)[2][:, bj.shape[1]:]
            step_r, aux = rs_rfo_step(bmv(q, g_flat),
                                      q @ h_eff @ q.mT, trust_new,
                                      saddle_order=saddle_order)
            step = bmv(q.mT, step_r)
        else:
            step, aux = rs_rfo_step(g_flat, h_eff, trust_new,
                                    saddle_order=saddle_order,
                                    eigh_impl=config.eigh_impl)
        if is_trim:
            # a trust-limited step (on the boundary) is replaced by the
            # level-shifted TRIM step
            so = max(saddle_order, 1) if kind == "prfo" else saddle_order
            t_step = trim_step(g_flat, h_eff, trust_new, saddle_order=so)
            on_boundary = (torch.linalg.vector_norm(step, dim=-1)
                           >= trust_new * (1.0 - 1e-9))
            step = torch.where(on_boundary[:, None], t_step, step)
        if is_mw:
            step = step * minv
        if dv:
            state_d = state.fo_state[-1]
            x_flat = state.coords.reshape(b, -1)
            if dv == "gediis":
                step, new_d = diis.gediis_step(state_d, x_flat, state.energy,
                                               g_flat, step)
            elif dv == "kdiis":
                step, new_d = diis.kdiis_step(state_d, x_flat, g_flat, step)
            elif dv in ("ediis", "adiis", "c2diis"):
                fn = {"ediis": diis.ediis_step, "adiis": diis.adiis_step,
                      "c2diis": diis.c2diis_step}[dv]
                step, new_d = fn(state_d, x_flat, state.energy, g_flat, step)
            else:
                step, new_d = diis.gdiis_step(state_d, x_flat, step, step)
            qn_fo = qn_fo + (new_d,)
        return step, h, trust_new, aux["predicted_energy_change"], qn_fo

    @spanned("step.solve")
    def first_order_move(state, g_flat):
        b = g_flat.shape[0]
        x_flat = state.coords.reshape(b, -1)
        fo_new = None
        if kind == "sd":
            mv = sd_step(g_flat, delta=config.delta)
        elif kind == "mwsd":
            mv = mwsd_step(g_flat, _masses3(z, g_flat.dtype, g_flat.device),
                           delta=config.delta)
        else:
            fo = state.fo_state[0]
            if kind in _FIRE:
                mv, fo_new = _FIRE[kind](fo, g_flat)
            elif kind == "lbfgs":
                mv, fo_new = lbfgs_step(fo, x_flat, g_flat,
                                        delta=config.delta)
            elif kind == "eve":
                mv, fo_new = ml.eve_step(fo, g_flat, state.energy,
                                         delta=0.03 * config.delta)
            elif kind == "gan":
                mv, fo_new = learned.gan_step(fo, x_flat, g_flat,
                                              state.energy,
                                              -config.delta * g_flat)
            elif kind == "rl":
                mv, fo_new = learned.rl_step(fo, g_flat, state.energy,
                                             -config.delta * g_flat)
            elif kind == "optax":
                mv, fo_new = ml.optax_step(sub, fo, g_flat,
                                           lr=0.05 * config.delta)
            elif kind == "gpmin":
                phi_fn, _ = gp.inv_dist_descriptor(state.coords.shape[1])
                mv, fo_new = gp.gp_step(fo, x_flat, state.energy, g_flat,
                                        phi_fn=phi_fn,
                                        max_step=0.5 * config.delta)
            else:
                mv, fo_new = cg_step(fo, g_flat, variant=sub,
                                     delta=config.delta)
        # clamp to the trust radius (ratio-adaptive for TR-L-BFGS)
        trust = new_trust(state) if sub == "tr" else state.trust_radius
        norm = torch.linalg.vector_norm(mv, dim=-1)
        mv = torch.where((norm > trust)[:, None],
                         mv * (trust / norm.clamp(min=1e-30))[:, None], mv)
        fo = (fo_new,) if fo_new is not None else ()
        return mv, state.hessian, trust, (g_flat * mv).sum(-1), fo

    @spanned("step")
    def step(state):
        b = state.coords.shape[0]
        count_members(state.converged)
        g = state.gradient
        with span("step.project"):
            # single-particle model surfaces live in the translation
            # subspace
            if config.project_tr_rot and state.coords.shape[1] > 1:
                g = project_gradient_tr_rot(g, state.coords)
            if constrained:
                g = constraints.project_gradient(g, state.coords)
        g_flat = g.reshape(b, -1)

        if is_dic:
            with span("step.solve"):
                mv_flat, h, trust, predicted, fo = dic_move(state, g_flat)
        elif kind in ("rfo", "prfo"):
            mv_flat, h, trust, predicted, fo = quasi_newton_move(state, g_flat)
        else:
            mv_flat, h, trust, predicted, fo = first_order_move(state, g_flat)
            if not fo:
                fo = state.fo_state

        if config.switch_method and kind in ("rfo", "prfo"):
            # sigmoid RMS-force blend toward the first-order engine at high
            # force (thresholds 0.05/0.005, steepness 10, offset 0.5)
            sk, _ = _parse_method(config.switch_method)
            sw_state = state.fo_state[-1]
            if sk in _FIRE:
                mv_fo, sw_new = _FIRE[sk](sw_state, g_flat)
            else:
                mv_fo, sw_new = sd_step(g_flat, delta=config.delta), sw_state
            rms = torch.sqrt((g_flat ** 2).mean(-1))
            x_j = torch.clamp((rms - 0.005) / (0.05 - 0.005), 0.0, 1.0)
            f_hi = torch.sigmoid(10.0 * (x_j - 0.5))
            f_hi = torch.where(rms > 0.05, 1.0,
                               torch.where(rms <= 0.005, 0.0, f_hi))[:, None]
            mv_flat = f_hi * mv_fo + (1.0 - f_hi) * mv_flat
            fo = fo + (sw_new,)

        move = mv_flat.reshape(state.coords.shape)
        move = torch.where(state.converged[:, None, None], 0.0, move)
        if constrained:
            move = move * constraints.mask(move.dtype, move.device)
        new_coords = state.coords + move
        if constrained:
            if constraint_targets is not None and constraints.n_constraints:
                # SHAKE the geometry back onto the constraint manifold
                new_coords = constraints.shake(new_coords, constraint_targets)
                move = new_coords - state.coords
        count("step_structures", new_coords.shape[0])
        e_new, g_new, raw_g_new = hosteval.eg_with_raw(calc, new_coords, z,
                                                       bias_engine)
        with span("step.accept"):
            conv_now = check_convergence(g, move, criteria)
            converged = state.converged | conv_now
            new_state = OptState(
                coords=new_coords, energy=e_new, gradient=g_new,
                raw_gradient=raw_g_new,
                prev_coords=state.coords, prev_energy=state.energy,
                prev_raw_gradient=state.raw_gradient,
                hessian=h, trust_radius=trust,
                predicted_change=predicted.to(state.energy.dtype),
                move=move, iteration=state.iteration + 1,
                converged=converged, fo_state=fo)

            # trust-region step rejection (minimization only): revert an
            # uphill move, shrink the radius, and learn the measured
            # curvature of the failed trial with one BFGS update
            if saddle_order == 0 and kind == "rfo":
                reject = (~state.converged) & ~conv_now & (
                    e_new > state.energy + 1e-14)
                s_trial = mv_flat
                y_trial = (raw_g_new - state.raw_gradient).reshape(b, -1)
                upd_ok = torch.isfinite(y_trial).all(-1) & (
                    (y_trial * s_trial).sum(-1) > 1e-14)
                h_learn = torch.where(
                    upd_ok[:, None, None],
                    update_hessian(h, s_trial, y_trial, "bfgs"), h)
                rejected = state._replace(
                    hessian=h_learn,
                    prev_coords=state.coords,
                    prev_raw_gradient=state.raw_gradient,
                    trust_radius=torch.clamp(
                        torch.linalg.vector_norm(mv_flat, dim=-1) * 0.25,
                        min=1e-5),
                    predicted_change=torch.zeros_like(state.predicted_change),
                    iteration=state.iteration + 1)
                new_state = _select(reject, rejected, new_state)

            # converged members keep their state frozen entirely
            return _select(state.converged,
                           state._replace(converged=converged), new_state)

    return step


class OptResult(NamedTuple):
    coords: torch.Tensor
    energy: torch.Tensor
    gradient: torch.Tensor
    converged: torch.Tensor
    n_iterations: int
    energy_history: np.ndarray
    coords_history: Optional[np.ndarray]


def dissociation_detected(coords, limit=10.0):
    """True if any atom's nearest neighbor is farther than `limit` Bohr."""
    c = np.asarray(coords.detach().cpu() if isinstance(coords, torch.Tensor)
                   else coords)
    if len(c) < 2:
        return False
    d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return bool(np.max(np.min(d, axis=1)) > limit)


def _model_hessian_fn(coords, z, config):
    """The mfc_count rebuild: primitives detected once on the starting
    structure (N,3); the kind of `init_hessian="model:<kind>"`, else the
    reference's default "lindh"."""
    if config.mfc_count <= 0:
        return None
    kind = (config.init_hessian.split(":", 1)[1]
            if config.init_hessian.startswith("model:") else "lindh")
    b, a, t = detect_primitives(coords.detach().cpu().numpy(), z)
    return make_model_hessian_fn(z, b, a, t, kind)


def _stop_requested(state, config, stop_file, dissociation_limit,
                    shape_conditions, detect_negative_eigenvalues):
    """The host's checks after a step (or a chunk), in the reference's
    order: stop file, dissociation, shape conditions (-sc), and a saddle
    search whose projected Hessian has no negative eigenvalue left
    (-negeigval, with exact Hessians)."""
    if stop_file and os.path.exists(stop_file):
        return True
    if dissociation_limit and dissociation_detected(
            host_read(torch.Tensor.cpu, state.coords[0]),
            dissociation_limit):
        return True
    if shape_conditions and judge_shape_condition(state.coords[0],
                                                  shape_conditions):
        return True
    if (detect_negative_eigenvalues and config.saddle_order > 0
            and config.fc_count > 0):
        h_proj = project_hessian_tr_rot(state.hessian[:1], state.coords[:1])
        if not np.any(np.linalg.eigvalsh(h_proj[0].cpu().numpy()) < -1e-10):
            print("# no negative eigenvalues while saddle_order > 0 "
                  "- stopping (ref -negeigval)")
            return True
    return False


def _stages(timer):
    """timer.stage, or a no-op context without a timer."""
    if timer is not None:
        return timer.stage
    return lambda name, block=None: contextlib.nullcontext()


def _save(checkpoint_path, state, it, config):
    from multioptpy_tpu_torch.checkpoint import save_checkpoint
    save_checkpoint(checkpoint_path, state,
                    meta={"iteration": it, "method": config.method})


def _optimize_chunked(step, state, config, record_trajectory=False,
                      callback=None, stop_file="end.txt",
                      dissociation_limit=None, shape_conditions=None,
                      detect_negative_eigenvalues=False,
                      checkpoint_path=None, checkpoint_every=0, timer=None):
    """`config.scan_chunk` steps between the host's checks, with the
    semantics of the reference's chunked driver (one `lax.scan` per chunk
    there, one launch sequence per step here):

    * a step whose energy is non-finite or beyond |E| > 1e8 is rejected:
      the state stays at the last finite one and the run stops at the end
      of the chunk ("runaway");
    * steps past `config.nsteps` (the chunk count rounds it up) are
      discarded;
    * `n_iterations` counts up to the step where convergence latched;
    * callbacks, checkpoints, the stop file, dissociation, shape conditions
      and -negeigval act at chunk boundaries.

    Steps that cannot change the state are not launched: those past the
    budget, and the rest of a chunk once the structure has converged
    (frozen) or a step was rejected (the reference discards them); their
    rows repeat the state, as the reference's do.
    """
    chunk = int(config.scan_chunk)
    stage = _stages(timer)
    energies = [host_read(float, state.energy[0])]
    traj = [state.coords[0].cpu().numpy()] if record_trajectory else None
    it = 0
    n_chunks = -(-config.nsteps // chunk)
    for ci in range(n_chunks):
        with stage("step"):
            stopped = torch.zeros_like(state.converged)
            e_h, conv_h, c_h = [], [], []
            for _ in range(min(chunk, config.nsteps - ci * chunk)):
                if host_read(bool, (state.converged | stopped).all()):
                    break
                new = step(state)
                active = (~stopped) & (state.iteration < config.nsteps)
                bad = active & (~torch.isfinite(new.energy)
                                | (new.energy.abs() > 1e8))
                state = _select((~active) | bad, state, new)
                stopped = stopped | bad
                e_h.append(state.energy[0])
                conv_h.append(state.converged[0])
                if record_trajectory:
                    c_h.append(state.coords[0])
            while len(e_h) < chunk:
                e_h.append(state.energy[0])
                conv_h.append(state.converged[0])
                if record_trajectory:
                    c_h.append(state.coords[0])
            # one transfer for everything the host inspects
            e_np = host_read(torch.Tensor.cpu, torch.stack(e_h)).numpy()
            conv_np = host_read(torch.Tensor.cpu, torch.stack(conv_h)).numpy()
        take = min(chunk, config.nsteps - ci * chunk)
        if conv_np.any():
            take = min(take, int(np.argmax(conv_np)) + 1)
        it = ci * chunk + take
        energies.extend(float(e) for e in e_np[:take])
        with span("loop"):
            with stage("host"):
                if record_trajectory:
                    traj.extend(c.cpu().numpy() for c in c_h[:take])
                if callback is not None:
                    callback(it, state)
                if (checkpoint_path and checkpoint_every
                        and (it // checkpoint_every)
                        > (max(it - chunk, 0) // checkpoint_every)):
                    _save(checkpoint_path, state, it, config)
            if host_read(bool, stopped[0]):
                print(f"# runaway detected (|E| > 1e8 or non-finite) in "
                      f"method={config.method} saddle_order="
                      f"{config.saddle_order} around iteration {it} - "
                      "keeping the last finite state")
                break
            if bool(conv_np[-1]):
                break
            if _stop_requested(state, config, stop_file, dissociation_limit,
                               shape_conditions,
                               detect_negative_eigenvalues):
                break
    return OptResult(
        coords=state.coords[0], energy=state.energy[0],
        gradient=state.gradient[0], converged=state.converged[0],
        n_iterations=it, energy_history=np.asarray(energies),
        coords_history=np.stack(traj) if record_trajectory else None)


def optimize(calc, coords, z, bias_engine=None, config=OptimizeConfig(),
             hessian0=None, record_trajectory=False, callback=None,
             constraints=None, stop_file="end.txt", dissociation_limit=None,
             shape_conditions=None, detect_negative_eigenvalues=False,
             checkpoint_path=None, checkpoint_every=0, resume_from=None,
             timer=None, device=None):
    """Host-driven optimization loop on one structure (N,3) with early exit.

    `device` (None means the CUDA card) must be where `calc` lives.
    `constraints` (a `Constraints`) project gradient, Hessian and step; the
    start is SHAKEn onto them. A `dic_*` method detects its primitives on
    the start. A `stop_file` in the working directory breaks the loop
    gracefully, `dissociation_limit` (Bohr) aborts a run whose molecule
    broke apart, `shape_conditions` (the -sc triples) abort when one is
    violated, and `detect_negative_eigenvalues` stops a saddle search (with
    `fc_count > 0`) whose projected Hessian lost its negative eigenvalues.
    `checkpoint_path` + `checkpoint_every` write resumable snapshots
    (`checkpoint.py`); `resume_from` restarts from one. `callback(it,
    state)` sees the batched state (batch of one). `timer` (a
    `logging_utils.StageTimer`) records the wall clock of the stages
    "step" (the step, up to its energy on the host) and "host" (the
    trajectory, callback and checkpoint), and is the current recorder of
    the call's spans: `job`, `init`, each `step` and `loop`, the `wait` of
    each host read, and what they call. With `config.scan_chunk > 1` the
    loop runs `_optimize_chunked`."""
    dev = calc_device(calc, device, "the optimization")
    x = on_device(coords, dev)[None]
    with recording(timer), span("job") as job:
        if job is not None:
            job.rec.note_job(1, x.shape[1], config.method)
        constraint_targets = None
        if constraints is not None:
            if constraints.n_atoms is None:
                constraints.n_atoms = x.shape[1]
            if constraints.n_constraints:
                constraint_targets = constraints.targets(x)
                x = constraints.shake(x, constraint_targets)
        internals = None
        if config.method.lower().startswith("dic"):
            internals = auto_internals(x[0].cpu().numpy(), np.asarray(z))
        if resume_from is not None:
            from multioptpy_tpu_torch.checkpoint import load_checkpoint
            state, _ = load_checkpoint(resume_from, device=dev)
        else:
            h0 = None if hessian0 is None else torch.as_tensor(
                hessian0, dtype=x.dtype, device=dev)
            state = init_state(x, z, calc, bias_engine, config, h0,
                               internals=internals)
        step = make_step_fn(calc, z, bias_engine, config,
                            _model_hessian_fn(x[0], z, config), constraints,
                            constraint_targets, internals=internals)
        checks = dict(stop_file=stop_file,
                      dissociation_limit=dissociation_limit,
                      shape_conditions=shape_conditions,
                      detect_negative_eigenvalues=detect_negative_eigenvalues)
        if config.scan_chunk and config.scan_chunk > 1:
            return _optimize_chunked(
                step, state, config, record_trajectory=record_trajectory,
                callback=callback, checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, timer=timer, **checks)

        stage = _stages(timer)
        energies = [host_read(float, state.energy[0])]
        traj = [state.coords[0].cpu().numpy()] if record_trajectory else None
        it = 0
        for it in range(1, config.nsteps + 1):
            with stage("step"):
                state = step(state)
                e_now = host_read(float, state.energy[0])  # waits for it
            energies.append(e_now)
            with span("loop"):
                with stage("host"):
                    if record_trajectory:
                        traj.append(state.coords[0].cpu().numpy())
                    if callback is not None:
                        callback(it, state)
                    if (checkpoint_path and checkpoint_every
                            and it % checkpoint_every == 0):
                        _save(checkpoint_path, state, it, config)
                if host_read(bool, state.converged[0]):
                    break
                if _stop_requested(state, config, **checks):
                    break
                if not np.isfinite(e_now) or abs(e_now) > 1e8:
                    print("# runaway detected (|E| > 1e8 or non-finite) - "
                          "aborting")
                    break

    return OptResult(
        coords=state.coords[0], energy=state.energy[0],
        gradient=state.gradient[0], converged=state.converged[0],
        n_iterations=it, energy_history=np.asarray(energies),
        coords_history=np.stack(traj) if record_trajectory else None)


def optimize_batch(calc, coords_batch, z, bias_engine=None,
                   config=OptimizeConfig(), n_steps=None, hessian0=None,
                   device=None, mesh=None, timer=None, callback=None):
    """Batched optimization: `n_steps` steps of the whole batch (B,N,3) in
    lockstep, converged members frozen, any method. `device` as in
    `optimize`. `callback(it, state)` runs after each step of the whole
    batch and reads nothing from the card unless it reads the state;
    `timer` as in `optimize` (its "step" stage is the step's launches:
    nothing waits for the card between steps).

    `mesh` (a `parallel.Mesh`) splits the batch over its shards: each
    shard's block advances through its own step on its own device, and the
    result is gathered in shard order on the mesh's first device, which
    `device`, if given, must be and `calc` must live on. `coords_batch`
    may come already split (a `ShardedTree`), and the callback sees the
    split state. A batch that does not divide runs whole on every shard,
    as the reference's replicated layout does."""
    n_steps = int(n_steps if n_steps is not None else config.nsteps)
    if mesh is not None:
        return _optimize_batch_sharded(calc, coords_batch, z, bias_engine,
                                       config, n_steps, hessian0, device,
                                       mesh, timer, callback)
    dev = calc_device(calc, device, "the optimization")
    x = on_device(coords_batch, dev)
    with recording(timer), span("job") as job:
        if job is not None:
            job.rec.note_job(x.shape[0], x.shape[1], config.method)
        h0 = None if hessian0 is None else torch.as_tensor(
            hessian0, dtype=x.dtype, device=dev)
        state = init_state(x, z, calc, bias_engine, config, h0)
        step = make_step_fn(calc, z, bias_engine, config)
        state, e_hist = _batch_loop(step, state, n_steps, timer, callback,
                                    lambda s: s.energy)
        e_hist = (host_read(torch.Tensor.cpu, torch.stack(e_hist)).numpy()
                  if e_hist else np.zeros((0, x.shape[0])))
    return OptResult(
        coords=state.coords, energy=state.energy, gradient=state.gradient,
        converged=state.converged, n_iterations=n_steps,
        energy_history=e_hist, coords_history=None)


def _batch_loop(step, state, n_steps, timer, callback, energy):
    """optimize_batch's lockstep loop: (the final state, each step's
    energies, `energy(state)`)."""
    stage = _stages(timer)
    e_hist = []
    for it in range(1, n_steps + 1):
        with stage("step"):
            state = step(state)
        with span("loop"), stage("host"):
            e_hist.append(energy(state))
            if callback is not None:
                callback(it, state)
    return state, e_hist


def _optimize_batch_sharded(calc, coords_batch, z, bias_engine, config,
                            n_steps, hessian0, device, mesh, timer,
                            callback):
    """optimize_batch over the shards of `mesh`, in lockstep."""
    from multioptpy_tpu_torch.parallel.mesh import (ShardedTree, map_shards,
                                                    mesh_device, shard_batch,
                                                    shard_calc)

    home = mesh_device(mesh, device)
    calc_device(calc, home, "the optimization")
    if isinstance(coords_batch, ShardedTree):
        if coords_batch.mesh is not mesh:
            raise ValueError("coords_batch is split over another mesh")
        x = coords_batch
    else:
        x = shard_batch(on_device(coords_batch, home), mesh,
                        mesh.axis_names[0])
    calcs = [shard_calc(calc, dev) for dev in mesh.devices]
    steps = [make_step_fn(c, z, bias_engine, config) for c in calcs]

    def init(i, dev, xs):
        h0 = None if hessian0 is None else torch.as_tensor(
            hessian0, dtype=xs.dtype, device=dev)
        return init_state(xs, z, calcs[i], bias_engine, config, h0)

    with recording(timer), span("job") as job:
        if job is not None:
            rows = [xs.shape[0] for xs in x.shards]
            job.rec.note_job(sum(rows) if x.split else rows[0],
                             x.shards[0].shape[1], config.method)
        state = map_shards(init, x)
        state, e_hist = _batch_loop(
            lambda st: map_shards(lambda i, dev, s: steps[i](s), st), state,
            n_steps, timer, callback,
            lambda st: st._replace(shards=tuple(s.energy for s in st.shards),
                                   axes=st.axes.energy).gather())
        final = state.gather()
        e_hist = (host_read(torch.Tensor.cpu, torch.stack(e_hist)).numpy()
                  if e_hist else np.zeros((0, final.coords.shape[0])))
    return OptResult(
        coords=final.coords, energy=final.energy, gradient=final.gradient,
        converged=final.converged, n_iterations=n_steps,
        energy_history=e_hist, coords_history=None)
