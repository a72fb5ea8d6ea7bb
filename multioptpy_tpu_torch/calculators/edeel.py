"""EDEEL: diabatic electron-transfer states from fragment energies, on
batched coordinates.

Counterpart of `multioptpy_tpu/calculators/edeel.py` (10.1039/D3RA05784D).
The reactant surface (V11: donor and acceptor in their initial oxidation
states) and the product surface (V22: after the electron transfer) are
sums of fragment energies from one backend at the fragment charges; the
seam of crossing is located by the penalty target

    E_sx = (V11 + V22)/2 + sigma (V11 - V22)^2.

Every piece is a calculator call on the batch of fragments, so the
gradients come from autograd.
"""

import numpy as np

from multioptpy_tpu_torch.calculators.base import (Calculator,
                                                   composite_hessian)


class EDEELCalculator(Calculator):
    """target: 'reactant' (V11) | 'product' (V22) | 'sx' (seam penalty).

    calc_factory(charge=, multiplicity=) builds one fragment calculator;
    charges: dict with keys d_init, a_init, d_final, a_final (fragment
    charges before and after the electron hop); multiplicities likewise
    (default 1; the on-device SQM smears its occupations, so open shells
    take fractional ones). Lives on the fragment calculators' device."""

    def __init__(self, calc_factory, donor_atoms, acceptor_atoms, charges,
                 multiplicities=None, target="sx", sigma=2.0, **kw):
        mult = multiplicities or {}
        self.calcs = {key: calc_factory(charge=charges[key],
                                        multiplicity=mult.get(key, 1))
                      for key in ("d_init", "a_init", "d_final", "a_final")}
        kw.setdefault("device", self.calcs["d_init"].device)
        super().__init__(**kw)
        self.donor = np.asarray([a - 1 for a in donor_atoms], np.int64)
        self.acceptor = np.asarray([a - 1 for a in acceptor_atoms], np.int64)
        self.target = target
        self.sigma = float(sigma)
        self.on_device = all(c.on_device for c in self.calcs.values())

    def _fragments(self, coords, z):
        z = np.asarray(z)
        return ((coords[:, self.donor], z[self.donor]),
                (coords[:, self.acceptor], z[self.acceptor]))

    def diabatic_energies(self, coords, z):
        """(V11, V22), each (B,)."""
        (xd, zd), (xa, za) = self._fragments(coords, z)
        v11 = self.calcs["d_init"].energy(xd, zd) \
            + self.calcs["a_init"].energy(xa, za)
        v22 = self.calcs["d_final"].energy(xd, zd) \
            + self.calcs["a_final"].energy(xa, za)
        return v11, v22

    def hessian(self, coords, z):
        return composite_hessian(self, coords, z)

    def energy(self, coords, z):
        v11, v22 = self.diabatic_energies(coords, z)
        if self.target == "reactant":
            return v11
        if self.target == "product":
            return v22
        return 0.5 * (v11 + v22) + self.sigma * (v11 - v22) ** 2
