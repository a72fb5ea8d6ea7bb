"""Analytic model surfaces for testing optimizers, NEB and IRC.

Counterpart of `multioptpy_tpu/calculators/model_surfaces.py`. Muller-Brown:
the standard 2-D double-barrier test surface (Muller & Brown, Theor. Chim.
Acta 53 (1979) 75). One "atom"; x/y are the surface coordinates and z is
harmonically confined so the geometry stays (B, 1, 3)-shaped like every
other calculator. Energies are scaled by `scale` (default 1e-3).

Known stationary points (unscaled MB units):
  min A (-0.5582, 1.4417)  E = -146.700
  min B (-0.0500, 0.4667)  E = -80.768
  min C ( 0.6235, 0.0280)  E = -108.167
  TS AB (-0.8220, 0.6243)  E = -40.665
  TS BC ( 0.2125, 0.2930)  E = -72.249
"""

import torch

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   register_calculator)

_A = (-200.0, -100.0, -170.0, 15.0)
_a = (-1.0, -1.0, -6.5, 0.7)
_b = (0.0, 0.0, 11.0, 0.6)
_c = (-10.0, -10.0, -6.5, 0.7)
_x0 = (1.0, 0.0, -0.5, -1.0)
_y0 = (0.0, 0.5, 1.5, 1.0)

MB_MIN_A = (-0.55822363, 1.44172584)
MB_MIN_B = (-0.05001083, 0.46669410)
MB_MIN_C = (0.62349942, 0.02803776)
MB_TS_AB = (-0.82200156, 0.62430581)
MB_TS_BC = (0.21248659, 0.29298833)


def muller_brown_energy(x, y):
    """Unscaled Muller-Brown energy of tensors (or floats) x, y."""
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    e = 0.0
    for i in range(4):
        e = e + _A[i] * torch.exp(
            _a[i] * (x - _x0[i]) ** 2
            + _b[i] * (x - _x0[i]) * (y - _y0[i])
            + _c[i] * (y - _y0[i]) ** 2)
    return e


@register_calculator("muller_brown")
class MullerBrown(Calculator):
    on_device = True

    def __init__(self, scale=1e-3, z_conf=1.0, **kw):
        super().__init__(**kw)
        self.scale = float(scale)
        self.z_conf = float(z_conf)

    def energy(self, coords, z):
        """(B, 1, 3) -> (B,)."""
        x, y, zz = coords[:, 0, 0], coords[:, 0, 1], coords[:, 0, 2]
        return self.scale * (muller_brown_energy(x, y)
                             + self.z_conf * zz * zz)
