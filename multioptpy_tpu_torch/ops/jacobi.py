"""Batched symmetric eigensolver: round-robin Jacobi as batched matmuls.

Counterpart of `multioptpy_tpu/ops/jacobi.py`. Each round applies D/2
disjoint Givens rotations composed into one block rotation G, so a round is
A <- G A G^T, V <- V G^T, re-symmetrized every round. A sweep is D-1 rounds.
This is what `eigh_impl="pallas"` runs on the CPU (the reference's CPU branch
of the same option; `ops/eigh64.plan` routes it), and the f64 polish of
`ops/eigh64.seeded_eigh` on every device. The hand-written kernel is
`ops/jacobi_cuda.py`.
"""

import numpy as np
import torch

from multioptpy_tpu_torch.logging_utils import count_eigh


def _round_robin_schedule(n):
    """(n-1, n/2, 2) static pairing schedule (n even), pairs sorted."""
    assert n % 2 == 0
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        ring = [0] + others
        pairs = [(ring[i], ring[n - 1 - i]) for i in range(n // 2)]
        rounds.append(sorted(tuple(sorted(p)) for p in pairs))
        others = [others[-1]] + others[:-1]
    return np.asarray(rounds, dtype=np.int32)


def pad_to_even(a):
    """(..., D0, D0) -> ((B, D, D), D0, batch_shape) with D = D0 rounded up
    to even. An odd D0 gets an isolated eigenvalue 1 + D0 max|a| (max per
    matrix) above the Gershgorin bound in the new corner; its rotations
    are exact identities, it sorts last and is stripped."""
    batch_shape = a.shape[:-2]
    d0 = a.shape[-1]
    a = a.reshape(-1, d0, d0)
    if d0 % 2 == 0:
        return a, d0, batch_shape
    pad = a.new_zeros((a.shape[0], d0 + 1, d0 + 1))
    pad[:, :d0, :d0] = a
    pad[:, d0, d0] = 1.0 + d0 * a.abs().amax(dim=(-2, -1))
    return pad, d0, batch_shape


def sort_and_trim(w, v, d0, batch_shape):
    """Ascending eigenpairs (stable on ties, as `jnp.argsort`), padding
    stripped, reshaped back to the caller's batch shape."""
    w, order = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, -1, order[:, None, :].expand_as(v))
    w = w[:, :d0]
    v = v[:, :d0, :d0]
    return w.reshape(*batch_shape, d0), v.reshape(*batch_shape, d0, d0)


def jacobi_eigh(a, sweeps=10):
    """Eigendecomposition of symmetric a (..., D, D), ascending eigenvalues.

    Returns (w, v) with a = v @ diag(w) @ v.T (the torch.linalg.eigh
    convention)."""
    count_eigh("cpu" if a.device.type == "cpu" else "jacobi", a)
    a, d0, batch_shape = pad_to_even(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    v0 = eye.expand(a.shape).clone()
    a, v = jacobi_sweeps(a, v0, sweeps)
    return sort_and_trim(torch.diagonal(a, dim1=-2, dim2=-1), v, d0,
                         batch_shape)


def jacobi_sweeps(a, v, sweeps):
    """`sweeps` full round-robin sweeps on batched symmetric a (B, d, d)
    (d even), accumulating the similarity transform into v (B, d, d).
    Returns (a, v) with the input a ~= v @ a_out @ v.T."""
    b, d, _ = a.shape
    schedule = torch.as_tensor(_round_robin_schedule(d), dtype=torch.long,
                               device=a.device)
    p_all, q_all = schedule[..., 0], schedule[..., 1]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    for _ in range(sweeps):
        for r in range(d - 1):
            p, q = p_all[r], q_all[r]
            app = a[:, p, p]
            aqq = a[:, q, q]
            apq = a[:, p, q]
            # "small" is relative: below ~1e-18 of the diagonal scale the
            # rotation is under f64 resolution, and tau is clamped finite
            small = (apq.abs() < 1e-30) | (
                apq.abs() <= 1e-18 * (app.abs() + aqq.abs()))
            tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
            tau = tau.clamp(-1e15, 1e15)
            # sign(0) = +1: equal diagonal entries need the 45-degree turn
            sgn = torch.where(tau >= 0.0, 1.0, -1.0).to(a.dtype)
            t = -sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            g = eye.expand(b, d, d).clone()
            g[:, p, p] = c
            g[:, q, q] = c
            g[:, p, q] = s
            g[:, q, p] = -s
            a = g @ a @ g.mT
            a = 0.5 * (a + a.mT)
            v = v @ g.mT
    return a, v
