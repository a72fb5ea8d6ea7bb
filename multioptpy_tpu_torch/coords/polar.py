"""N-dimensional hyperspherical (polar) coordinates.

Counterpart of `multioptpy_tpu/coords/polar.py`: the sphere-surface
parametrization of the SHS-style searches, differentiable, with the
Jacobian d cart / d polar by forward-mode autodiff.
"""

import torch


def cart2polar(point, reference_point=None):
    """(n,) cartesian -> (n,) [r, theta_1..theta_{n-2}, phi]."""
    if reference_point is not None:
        point = point - reference_point
    n = point.shape[0]
    r = torch.linalg.vector_norm(point)
    thetas = [torch.arccos(torch.clamp(
        point[i] / torch.sqrt((point[i:] ** 2).sum() + 1e-30), -1.0, 1.0))
        for i in range(n - 2)]
    phi = torch.arctan2(point[-1], point[-2])
    phi = torch.where(phi < 0, phi + 2 * torch.pi, phi)
    return torch.stack([r, *thetas, phi])


def polar2cart(polar, reference_point=None):
    """Inverse transform."""
    r = polar[0]
    angles = polar[1:]
    coords = []
    sin_prod = r
    for i in range(polar.shape[0] - 1):
        coords.append(sin_prod * torch.cos(angles[i]))
        sin_prod = sin_prod * torch.sin(angles[i])
    coords.append(sin_prod)
    out = torch.stack(coords)
    if reference_point is not None:
        out = out + reference_point
    return out


def polar_jacobian(polar, reference_point=None):
    """d cart / d polar, (n, n), by forward-mode autodiff."""
    return torch.func.jacfwd(lambda p: polar2cart(p, reference_point))(polar)


def cart_grad_to_polar_grad(x, grad_x, reference_point=None):
    """grad_p = J^T grad_x with J = d cart / d polar at p = cart2polar(x):
    the chain rule the reference writes, not the upstream code's first
    Jacobian column (which evaluates cart2polar on a polar vector)."""
    p = cart2polar(x, reference_point)
    return polar_jacobian(p, reference_point).mT @ grad_x
