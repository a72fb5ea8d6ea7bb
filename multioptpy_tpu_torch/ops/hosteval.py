"""Host-level calculator calls between driver stages, with bias.

Counterpart of `multioptpy_tpu/ops/hosteval.py`. The reference jit-compiles
these glue expressions once per calculator and shape; PyTorch runs eagerly,
so here they are plain functions of batched coordinates (B, N, 3). Each
call of the calculator's energy and gradient or Hessian is a `step.calc`
span: what lies inside it and outside the calculator's own `calc` span is
the cost of the calculator's boundary (a wrapper around it).
"""

from multioptpy_tpu_torch.logging_utils import span


def _biased(bias_engine):
    return bias_engine is not None and len(bias_engine)


def energy_and_gradient(calc, coords, z, bias_engine=None):
    """(e (B,), g (B,N,3)) with bias included."""
    with span("step.calc"):
        e, g = calc.energy_and_gradient(coords, z)
    if _biased(bias_engine):
        be, bg = bias_engine.energy_and_gradient(coords)
        e, g = e + be, g + bg
    return e, g


def eg_with_raw(calc, coords, z, bias_engine=None):
    """(e_eff, g_eff, raw_g): the init_state triple."""
    with span("step.calc"):
        e, g = calc.energy_and_gradient(coords, z)
    raw_g = g
    if _biased(bias_engine):
        be, bg = bias_engine.energy_and_gradient(coords)
        e, g = e + be, g + bg
    return e, g, raw_g


def energy(calc, coords, z, bias_engine=None):
    """(B,) energies with bias."""
    e = calc.energy(coords, z).detach()
    if _biased(bias_engine):
        e = e + bias_engine.total_energy(coords).detach()
    return e


def hessian(calc, coords, z, bias_engine=None):
    """Exact (numerical or autodiff) Hessians (B, 3N, 3N) with bias."""
    with span("step.calc"):
        h = calc.hessian(coords, z)
    if _biased(bias_engine):
        h = h + bias_engine.hessian(coords)
    return h


def hessian_and_modes(calc, coords, z, bias_engine=None):
    """(hessian (B,3N,3N), frequencies_cm1 (B,3N)): the Hessian and its
    mass-weighted normal-mode frequencies (AutoTS step-3 glue)."""
    from multioptpy_tpu_torch.analysis.vibrations import normal_modes

    h = hessian(calc, coords, z, bias_engine)
    return h, normal_modes(h, coords, z).frequencies_cm1
