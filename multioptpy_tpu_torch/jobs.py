"""Programmatic job API: thin objects over the drivers, for users who
compose workflows in Python.

Counterpart of `multioptpy_tpu/jobs.py`. Each Job reads its structure (an
xyz file or coordinates in Bohr), builds its calculator by name on
`device` (None means the CUDA card) and runs one driver with keyword
options:

    job = OptimizationJob("mol.xyz", calculator="lj", method="rfo_fsb",
                          device="cpu")
    result = job.run()
"""

import numpy as np
import torch

from multioptpy_tpu_torch.calculators import get_calculator
from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.io import read_xyz
from multioptpy_tpu_torch.periodic import symbols_to_z
from multioptpy_tpu_torch.units import ANGSTROM2BOHR


class _Job:
    def __init__(self, input_file=None, coords=None, z=None, symbols=None,
                 calculator="lj", charge=0, multiplicity=1, calc_options=None,
                 device=None, **options):
        self.device = resolve_device(device)
        if input_file is not None:
            symbols, coords_ang = read_xyz(input_file)
            z = symbols_to_z(symbols)
            coords = coords_ang * ANGSTROM2BOHR
        self.symbols = symbols
        self.coords = torch.as_tensor(coords, dtype=torch.float64,
                                      device=self.device)
        self.z = np.asarray(z)
        self.calc = get_calculator(calculator, charge=charge,
                                   multiplicity=multiplicity,
                                   device=self.device,
                                   **(calc_options or {}))
        self.options = options
        self.result = None

    def set_options(self, **kw):
        self.options.update(kw)
        return self

    def _end(self, end_input, end_coords):
        """The second structure (Bohr) from an xyz file or coordinates."""
        if end_input is not None:
            end_coords = read_xyz(end_input)[1] * ANGSTROM2BOHR
        if end_coords is None:
            return None
        return torch.as_tensor(end_coords, dtype=torch.float64,
                               device=self.device)


class OptimizationJob(_Job):
    """`optimize` with OptimizeConfig options (plus `constraints` and
    `bias_engine`)."""

    def run(self):
        from multioptpy_tpu_torch.drivers.optimize import (OptimizeConfig,
                                                           optimize)

        constraints = self.options.pop("constraints", None)
        bias = self.options.pop("bias_engine", None)
        config = OptimizeConfig(**self.options)
        self.result = optimize(self.calc, self.coords, self.z,
                               bias_engine=bias, config=config,
                               constraints=constraints, device=self.device)
        return self.result


class NEBJob(_Job):
    """`neb` between the structure and `end_input` (or `end_coords`), over a
    linear path of `n_images` unless `path0` is given."""

    def __init__(self, *a, end_input=None, end_coords=None, n_images=12,
                 **kw):
        super().__init__(*a, **kw)
        self.end_coords = self._end(end_input, end_coords)
        self.n_images = n_images

    def run(self):
        from multioptpy_tpu_torch.drivers.neb import (NEBConfig,
                                                      interpolate_linear, neb)

        path0 = self.options.pop("path0", None)
        if path0 is None:
            path0 = interpolate_linear(self.coords, self.end_coords,
                                       self.n_images)
        config = NEBConfig(**self.options)
        self.result = neb(self.calc, path0, self.z, config,
                          device=self.device)
        return self.result


class MDJob(_Job):
    """`run_md` with MDConfig options (plus `bias_engine`)."""

    def run(self):
        from multioptpy_tpu_torch.drivers.md import MDConfig, run_md

        bias = self.options.pop("bias_engine", None)
        config = MDConfig(**self.options)
        self.result = run_md(self.calc, self.coords, self.z, config,
                             bias_engine=bias, device=self.device)
        return self.result


class IEIPJob(_Job):
    """`ieip` between the structure and `end_input` (or `end_coords`)."""

    def __init__(self, *a, end_input=None, end_coords=None, **kw):
        super().__init__(*a, **kw)
        self.end_coords = self._end(end_input, end_coords)

    def run(self):
        from multioptpy_tpu_torch.drivers.ieip import IEIPConfig, ieip

        config = IEIPConfig(**self.options)
        self.result = ieip(self.calc, self.coords, self.end_coords, self.z,
                           config, device=self.device)
        return self.result


class AutoTSJob(_Job):
    """The AutoTS pipeline from the structure (to `product_coords` when
    given) with AutoTSConfig options."""

    def __init__(self, *a, product_coords=None, **kw):
        super().__init__(*a, **kw)
        self.product_coords = self._end(None, product_coords)

    def run(self):
        from multioptpy_tpu_torch.workflows.autots import AutoTSConfig, autots

        config = AutoTSConfig(**self.options)
        self.result = autots(self.calc, self.coords, self.z, config,
                             product_coords=self.product_coords,
                             device=self.device)
        return self.result
