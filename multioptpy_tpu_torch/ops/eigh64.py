"""f64 symmetric eigensolver helpers and their closed-form derivatives.

Counterpart of `multioptpy_tpu/ops/eigh64.py`. Hopper has native FP64, so
`eigh_fast` is `torch.linalg.eigh` and `solve_f64safe` a plain solve (the
reference's CPU branches). `seeded_eigh` keeps the f32-seed + f64 Jacobi
polish; its f32 seed is the Hopper Jacobi kernel on CUDA, as the TPU branch
used the Pallas kernel. `eigh_solve` and `inv_sqrt_psd` are
`torch.autograd.Function`s whose backward passes are the transposes of the
reference's JVP rules.
"""

import torch

from multioptpy_tpu_torch.ops.jacobi import (jacobi_sweeps, pad_to_even,
                                              sort_and_trim)


def _seed_eigh_f32(a32):
    """f32 eigendecomposition: the Jacobi kernel on CUDA, LAPACK on the CPU."""
    if a32.is_cuda:
        from multioptpy_tpu_torch.ops.jacobi_cuda import jacobi_eigh_auto

        return jacobi_eigh_auto(a32, sweeps=8)
    return torch.linalg.eigh(a32)


def seeded_eigh(a, polish_sweeps=2):
    """Eigendecomposition of symmetric f64 a (..., D, D), ascending; returns
    (w, v) with a = v @ diag(w) @ v.T. f32 seed, one Newton
    orthonormalization, then `polish_sweeps` f64 round-robin sweeps."""
    a, d0, batch_shape = pad_to_even(a)
    d = a.shape[-1]
    dtype = a.dtype
    _, v32 = _seed_eigh_f32(a.to(torch.float32))
    v = v32.to(dtype)
    eye = torch.eye(d, dtype=dtype, device=a.device)
    vtv = v.mT @ v
    v = v @ (1.5 * eye - 0.5 * vtv)
    a1 = v.mT @ (a @ v)
    a1 = 0.5 * (a1 + a1.mT)
    a1, v = jacobi_sweeps(a1, v, polish_sweeps)
    return sort_and_trim(torch.diagonal(a1, dim1=-2, dim2=-1), v, d0,
                         batch_shape)


def eigh_fast(a, polish_sweeps=2):
    """The eigh entry point of the f64 hot paths: torch.linalg.eigh."""
    del polish_sweeps
    return torch.linalg.eigh(a)


def eigh_deflated(h_proj, p, shift=1e3):
    """Eigendecomposition of a TR/rot-projected symmetric matrix with the
    projected-out block shifted to `shift` (h_proj and I - P commute, so the
    eigenvectors are unchanged) and each eigenvalue restored afterwards.
    Returns (w, v) ascending, projected-out modes back at ~0."""
    eye = torch.eye(h_proj.shape[-1], dtype=h_proj.dtype,
                    device=h_proj.device)
    w, v = eigh_fast(h_proj + shift * (eye - p))
    q = 1.0 - (v * (p @ v)).sum(-2)
    w = w - shift * q
    w, order = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, -1, order[..., None, :].expand_as(v))
    return w, v


class _EighSolve(torch.autograd.Function):
    """x = A^-1 b through one eigh of symmetric A. Backward (transpose of
    the reference JVP dx = A^-1 (db - dA x)): b_bar = A^-1 x_bar,
    A_bar = -b_bar x^T."""

    @staticmethod
    def forward(ctx, a, b):
        w, v = eigh_fast(a)
        x = v @ ((v.mT @ b[..., None])[..., 0] / w)[..., None]
        x = x[..., 0]
        ctx.save_for_backward(w, v, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        w, v, x = ctx.saved_tensors
        lam = (v @ ((v.mT @ x_bar[..., None])[..., 0] / w)[..., None])[..., 0]
        return -lam[..., :, None] * x[..., None, :], lam


def eigh_solve(a, b):
    """Solve symmetric (possibly indefinite) a @ x = b for vectors b (..., n)
    through one `eigh_fast` factorization; degeneracy-safe derivative."""
    return _EighSolve.apply(a, b)


class _InvSqrtPSD(torch.autograd.Function):
    """S^-1/2 = V w^-1/2 V^T with eigenvalues floored at floor * max(w).
    Backward: the Daleckii-Krein map is self-adjoint, so
    S_bar = V (F * (V^T Y_bar V)) V^T with the cancellation-free Loewner
    matrix F_ij = -1 / (sqrt(w_i) sqrt(w_j) (sqrt(w_i) + sqrt(w_j)))."""

    @staticmethod
    def forward(ctx, s, floor):
        w, v = eigh_fast(s)
        w = torch.maximum(w, floor * w.amax(-1, keepdim=True))
        ctx.save_for_backward(w, v)
        return (v * w[..., None, :] ** -0.5) @ v.mT

    @staticmethod
    def backward(ctx, y_bar):
        w, v = ctx.saved_tensors
        sq = torch.sqrt(w)
        f = -1.0 / (sq[..., :, None] * sq[..., None, :]
                    * (sq[..., :, None] + sq[..., None, :]))
        return v @ (f * (v.mT @ y_bar @ v)) @ v.mT, None


def inv_sqrt_psd(s, floor=1e-12):
    """S^{-1/2} of symmetric PSD matrices (..., n, n) via one eigh."""
    return _InvSqrtPSD.apply(s, floor)


def solve_f64safe(a, b, assume_sym=False):
    """A linear solve; Hopper factorizes f64 natively (the reference's CPU
    branch), so `assume_sym` changes nothing here."""
    del assume_sym
    return torch.linalg.solve(a, b)
