"""The traffic generator: the starting geometries of every job from a
configuration, a traffic mix and the run's seed.

A mix is a JSON file of parameters (`traffic/<mix>.json`) whose `kind`
names a module `kinds/<kind>.py`: how the kind's jobs start (`prepare`,
`start`) and which entry of the program drives them (`run`). A new kind is
a new file there. The helpers below draw geometries for every kind.

Geometries are numpy float64 arrays in Bohr.
"""

import importlib
import re

import numpy as np

ANGSTROM2BOHR = 1.0 / 0.52917721067


def rng_of(*keys):
    """A numpy generator from whole numbers of any size (seeds reach past
    32 and 63 bits)."""
    return np.random.default_rng([int(k) % 2 ** 64 for k in keys])


def base_geometry(config):
    """(N, 3) Bohr and (N,) atomic numbers of the configuration."""
    mol = config["molecule"]
    return np.asarray(mol["coords_bohr"], np.float64), np.asarray(mol["z"])


def rotation(rng):
    """A uniform random rotation (3, 3): QR of a Gaussian matrix."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def displaced(x, sigma_ang, rng, n):
    """(n, N, 3): x with Gaussian displacements of sigma_ang Angstrom."""
    return x[None] + sigma_ang * ANGSTROM2BOHR * rng.standard_normal(
        (n,) + x.shape)


def orientations(x, fragment, n, max_shift, distance_ang, rng):
    """(n, N, 3) rigid placements of the 1-based `fragment` atoms: a
    uniform rotation about the fragment's centre, placed `distance_ang`
    Angstrom from the other atoms' centre, then a uniform shift of up to
    `max_shift` Bohr per axis, redrawn (20 times at most) while any of its
    atoms lies within 1.5 Bohr of another atom."""
    idx = np.asarray(fragment) - 1
    rest = np.setdiff1d(np.arange(len(x)), idx)
    rest_c = x[rest].mean(0)
    axis = x[idx].mean(0) - rest_c
    axis = axis / np.linalg.norm(axis)
    place = rest_c + axis * distance_ang * ANGSTROM2BOHR
    frag = x[idx] - x[idx].mean(0) + place
    out = []
    for _ in range(n):
        new = x.copy()
        rot = rotation(rng)
        for _try in range(21):
            new[idx] = (frag - place) @ rot.T + place + rng.uniform(
                -max_shift, max_shift, 3)
            if np.linalg.norm(new[idx][:, None] - new[rest][None],
                              axis=-1).min() > 1.5:
                break
        out.append(new)
    return np.stack(out)


def kind(name):
    """The module `kinds/<name>.py` of a traffic kind."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", str(name)):
        raise ValueError(f"bad traffic kind {name!r}")
    return importlib.import_module(f"gpu_bench.kinds.{name}")


class Traffic:
    """The jobs of one cell's run."""

    def __init__(self, config, mix, seed):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.x, self.z = base_geometry(config)
        self.kind = kind(mix["kind"])
        self.batched = self.kind.BATCHED
        self.kind.prepare(self)

    def job(self, j):
        """The starting geometry of job j: (N, 3), or (B, N, 3) for a
        batched kind. Negative j are warm-up jobs, drawn apart."""
        rng = rng_of(self.seed, j) if j >= 0 else rng_of(2 ** 63, -j)
        return self.kind.start(self, j, rng)
