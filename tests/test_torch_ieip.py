"""Port parity: multioptpy_tpu_torch.drivers.ieip against the JAX package on
the Muller-Brown surface: the elastic image pair, the spring pair and the
dimer method give the same TS guess, images, iteration count and energy
(1e-10 relative; Bohr and Hartree)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multioptpy_tpu.calculators.model_surfaces import MullerBrown as RefMB
from multioptpy_tpu.drivers import ieip as ref_ieip
from multioptpy_tpu_torch.calculators.model_surfaces import (MB_MIN_A,
                                                             MB_MIN_B,
                                                             MB_TS_AB,
                                                             MullerBrown)
from multioptpy_tpu_torch.drivers import ieip

torch.set_num_threads(1)

_Z = np.array([1])


def _pt(xy, dx=0.0, dy=0.0):
    return np.array([[xy[0] + dx, xy[1] + dy, 0.0]])


_CASES = {
    "eip": (_pt(MB_MIN_A), _pt(MB_MIN_B),
            dict(engine="eip", n_steps=120, step_size=0.02,
                 pull_strength=0.02, min_pair_distance=0.05)),
    "spring_pair": (_pt(MB_MIN_A), _pt(MB_MIN_B),
                    dict(engine="spring_pair", n_steps=60, step_size=0.03,
                         pull_strength=0.05, min_pair_distance=0.3)),
    "dimer": (_pt(MB_TS_AB, -0.08, -0.05), _pt(MB_TS_AB, 0.08, 0.05),
              dict(engine="dimer", n_steps=80, step_size=0.02, fmax=1e-6)),
}


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-300)


@pytest.mark.parametrize("engine", sorted(_CASES))
def test_engine_matches_reference(engine):
    a, b, kw = _CASES[engine]
    ref = ref_ieip.ieip(RefMB(), jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(_Z), ref_ieip.IEIPConfig(**kw))
    got = ieip.ieip(MullerBrown(device="cpu"), torch.as_tensor(a),
                    torch.as_tensor(b), _Z, ieip.IEIPConfig(**kw),
                    device="cpu")
    assert got.n_iterations == ref.n_iterations
    assert got.converged == ref.converged
    assert got.ts_energy == pytest.approx(ref.ts_energy, rel=1e-10)
    for name in ("ts_guess", "image_a", "image_b"):
        assert _rel(getattr(got, name).numpy(), getattr(ref, name)) < 1e-10


def test_unknown_engine_and_device():
    a, b, _ = _CASES["eip"]
    with pytest.raises(ValueError, match="unknown iEIP engine"):
        ieip.ieip(MullerBrown(device="cpu"), a, b, _Z,
                  ieip.IEIPConfig(engine="neb"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ieip.ieip(MullerBrown(device="cpu"), a, b, _Z)
