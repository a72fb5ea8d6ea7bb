"""Calculator protocol: batched energy backends on tensors.

Counterpart of `multioptpy_tpu/calculators/base.py`. A calculator is a
function of a batch of geometries:

    energy(coords_bohr (B, N, 3), z (N,) ints) -> Hartree (B,)

Gradients come from autograd of the summed batch energy (members are
independent, so each member's gradient is its own), and the seminumerical
Hessian evaluates all 6N displaced gradients of all B structures as one
batch.

Every calculator's `energy_and_gradient`, `hessian` and
`numerical_hessian` run inside a `calc` span (a subclass's own are wrapped
when the class is defined); the outermost of them counts the structures
whose energy and gradient it evaluates (`gradients`), the seminumerical
Hessian its 6N displaced structures per member. The seminumerical Hessian
opens a `calc.hessian` span around its displaced batch, in which the
batch's gradient opens no `calc` of its own, and counts one `hessians` a
member.
"""

import functools

import numpy as np
import torch

from multioptpy_tpu_torch.device import resolve_device
from multioptpy_tpu_torch.logging_utils import count, current, span, spanned

_SPANNED = ("energy_and_gradient", "hessian", "numerical_hessian")


def _calc_span(fn):
    """fn(self, coords, z, ...) inside a `calc` span; an outermost
    energy_and_gradient counts its B structures."""
    if getattr(fn, "_calc_span", False):
        return fn
    gradients = fn.__name__ == "energy_and_gradient"

    @functools.wraps(fn)
    def call(self, coords, z, *args, **kwargs):
        rec = current()
        if rec is None or rec.innermost() == "calc.hessian":
            return fn(self, coords, z, *args, **kwargs)
        with rec.span("calc") as opened:
            if gradients and opened is not None:
                rec.count("gradients", coords.shape[0])
            return fn(self, coords, z, *args, **kwargs)

    call._calc_span = True
    return call


class Calculator:
    """Base class. Subclasses implement `energy(coords, z)`.

    `device` (None means the CUDA card) is where the calculator's parameter
    tensors live; callers pass coordinates on the same device."""

    on_device = True
    name = "base"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in _SPANNED:
            if name in cls.__dict__:
                setattr(cls, name, _calc_span(cls.__dict__[name]))

    def __init__(self, charge=0, multiplicity=1, device=None, **kwargs):
        self.charge = int(charge)
        self.multiplicity = int(multiplicity)
        self.device = resolve_device(device)
        self.options = kwargs

    def energy(self, coords, z):
        raise NotImplementedError

    def energy_and_gradient(self, coords, z):
        """-> (E (B,), g (B, N, 3)), both detached."""
        with torch.enable_grad():
            x = coords.detach().requires_grad_(True)
            with span("calc.forward"):
                e = self.energy(x, z)
            with span("calc.backward"):
                (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), g

    def gradient(self, coords, z):
        return self.energy_and_gradient(coords, z)[1]

    def hessian(self, coords, z):
        """Exact Hessians (B, 3N, 3N): forward-over-reverse autodiff of each
        member's energy (SQM/SQM2 override this with their seminumerical
        Hessian)."""
        b, n, _ = coords.shape

        def one(x_flat):
            return self.energy(x_flat.reshape(1, n, 3), z)[0]

        return torch.func.vmap(torch.func.hessian(one))(
            coords.detach().reshape(b, 3 * n))

    @spanned("calc.hessian")
    def numerical_hessian(self, coords, z, step=1e-3):
        """Central-difference Hessians (B, 3N, 3N) of the analytic gradient:
        all 6N displaced gradients of all B structures in one batch."""
        b, n, _ = coords.shape
        n3 = 3 * n
        eye = torch.eye(n3, dtype=coords.dtype, device=coords.device) * step
        flat = coords.reshape(b, 1, n3)
        disp = torch.cat([flat + eye, flat - eye], dim=1)   # (B, 6N, 3N)
        count("gradients", b * 2 * n3)
        count("hessians", b)
        g = self.energy_and_gradient(disp.reshape(b * 2 * n3, n, 3), z)[1]
        g = g.reshape(b, 2, n3, n3)
        h = (g[:, 0] - g[:, 1]) / (2.0 * step)
        return 0.5 * (h + h.mT)


for _name in _SPANNED:
    setattr(Calculator, _name, _calc_span(getattr(Calculator, _name)))


def composite_hessian(calc, coords, z):
    """The Hessian of a composite calculator (ONIOM, the two-state model
    functions, BITSS, EDEEL): central differences (step 1e-4 Bohr, SQM's
    own) of its analytic gradient, the 6N displaced structures of every
    member as one batch. The reference differentiates twice through its
    pieces; SQM's custom autograd functions have no forward mode here, so
    the port differences the gradient instead (ROADMAP Queue 3, D3)."""
    return calc.numerical_hessian(coords, z, step=1e-4)


class BondGradProjWrapper(Calculator):
    """Zero the bond-stretch gradient between atom pairs (-gfix): each
    listed pair's stretch direction, rebuilt from the current geometry, is
    projected out of the gradient, so that bond feels no force while the
    rest relaxes. Energies and Hessians are the inner calculator's."""

    def __init__(self, inner, pairs):
        self.inner = inner
        self.on_device = inner.on_device
        self.name = f"gfix({inner.name})"
        self.charge = inner.charge
        self.multiplicity = inner.multiplicity
        self.device = inner.device
        self.options = inner.options
        self.pairs = tuple((int(i) - 1, int(j) - 1) for i, j in pairs)

    def energy(self, coords, z):
        return self.inner.energy(coords, z)

    def _b_rows(self, coords):
        """(B, P, 3N) unit stretch directions."""
        rows = []
        for i, j in self.pairs:
            d = coords[:, i] - coords[:, j]
            u = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True)
                     + 1e-30)
            row = torch.zeros_like(coords)
            row[:, i] = u
            row[:, j] = -u
            rows.append(row.reshape(coords.shape[0], -1))
        return torch.stack(rows, dim=1)

    def energy_and_gradient(self, coords, z):
        e, g = self.inner.energy_and_gradient(coords, z)
        b = self._b_rows(coords)
        eye = torch.eye(b.shape[1], dtype=b.dtype, device=b.device)
        g_flat = g.reshape(g.shape[0], -1)
        coef = torch.linalg.solve_ex(b @ b.mT + 1e-12 * eye,
                                     (b @ g_flat[..., None])[..., 0])[0]
        return e, (g_flat - (b.mT @ coef[..., None])[..., 0]).reshape(
            g.shape)

    def hessian(self, coords, z):
        return self.inner.hessian(coords, z)


class FragmentGradWrapper(Calculator):
    """Rigid-fragment gradient filter (-of): within each listed fragment
    (1-based atoms) the gradient is replaced by its mean, so those atoms
    move as one rigid translation unit. The averaging is one (N, N)
    projection applied to every member of the batch."""

    def __init__(self, inner, fragments, n_atoms):
        self.inner = inner
        self.on_device = inner.on_device
        self.name = f"fragopt({inner.name})"
        self.charge = inner.charge
        self.multiplicity = inner.multiplicity
        self.device = inner.device
        self.options = inner.options
        p = np.eye(n_atoms)
        for frag in fragments:
            idx = [int(a) - 1 for a in frag]
            for i in idx:
                p[i, :] = 0.0
                for j in idx:
                    p[i, j] = 1.0 / len(idx)
        self._proj = p

    def energy(self, coords, z):
        return self.inner.energy(coords, z)

    def energy_and_gradient(self, coords, z):
        e, g = self.inner.energy_and_gradient(coords, z)
        return e, torch.as_tensor(self._proj, dtype=g.dtype,
                                  device=g.device) @ g

    def hessian(self, coords, z):
        return self.inner.hessian(coords, z)


_REGISTRY = {}


def register_calculator(name):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_calculator(name, **kwargs):
    """Instantiate a backend by name: the on-device "lj", "emt",
    "tersoff", "sqm", "sqm2" and "muller_brown", or a host bridge
    ("tblite", "dxtb", "pyscf", "psi4", "ase", "gpaw", "pwscf"), which
    raises ImportError where its library is absent."""
    from multioptpy_tpu_torch.calculators import (  # noqa: F401
        emt, host, lj, model_surfaces, sqm, tersoff)
    if name not in _REGISTRY:
        raise KeyError(f"unknown calculator '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_calculators():
    from multioptpy_tpu_torch.calculators import (  # noqa: F401
        emt, host, lj, model_surfaces, sqm, tersoff)
    return sorted(_REGISTRY)
