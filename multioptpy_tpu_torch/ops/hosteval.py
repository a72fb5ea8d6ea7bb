"""Host-level calculator calls between driver stages.

Counterpart of `multioptpy_tpu/ops/hosteval.py`. The reference jit-compiles
these glue expressions once per calculator and shape; PyTorch runs eagerly,
so here they are plain functions. Bias potentials arrive with AFIR (ROADMAP
Queue 1 item 7).
"""


def _no_bias(bias_engine):
    if bias_engine is not None and len(bias_engine):
        raise NotImplementedError(
            "bias potentials arrive with AFIR (ROADMAP Queue 1 item 7)")


def energy_and_gradient(calc, coords, z, bias_engine=None):
    """(e (B,), g (B,N,3))."""
    _no_bias(bias_engine)
    return calc.energy_and_gradient(coords, z)


def eg_with_raw(calc, coords, z, bias_engine=None):
    """(e_eff, g_eff, raw_g): the init_state triple."""
    e, g = energy_and_gradient(calc, coords, z, bias_engine)
    return e, g, g


def hessian(calc, coords, z, bias_engine=None):
    """Exact (numerical or autodiff) Hessians (B, 3N, 3N)."""
    _no_bias(bias_engine)
    return calc.hessian(coords, z)
