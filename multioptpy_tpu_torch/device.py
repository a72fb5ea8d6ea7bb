"""Device selection shared by every entry point of the port, the batched
matrix-vector product of its step paths, and the card timer its scripts
share."""

import time

import numpy as np
import torch


def resolve_device(device=None):
    """`device` as a torch.device; None means the CUDA card.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never carries on quietly on the CPU. On CUDA, TF32 is turned
    off for matmuls and convolutions, the counterpart of the reference's
    `Precision.HIGHEST` matmuls."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def calc_device(calc, device=None, what="the run"):
    """`device` resolved as `resolve_device` does; raises unless `calc`
    lives there."""
    dev = resolve_device(device)
    if calc.device != dev:
        raise ValueError(f"the calculator lives on {calc.device}, but {what} "
                         f"was asked to run on {dev}")
    return dev


def on_device(x, dev):
    """A tensor (detached) or array-like on `dev`, its dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def bmv_reduce(a, x):
    """`bmv`'s form on the card: (a * x) summed over the last axis of a
    contiguous a."""
    return (a.contiguous() * x[..., None, :]).sum(-1)


def bmv(a, x):
    """Batched matrix-vector product a @ x: (..., M, K) and (..., K) ->
    (..., M), the one form of every step path's matrix-vector products, so
    that a member's result does not depend on how many others share its
    batch (ROADMAP Queue 3, F12).

    On the card: an elementwise product summed over the last axis of a
    contiguous a, whose reduction order is set by M and K alone (cuBLAS
    picks its kernel for `a @ x[..., None]`, einsum or torch.bmm by the
    batch count: 1.9e-6 apart in f32 between batches of 64 and 256). On
    the CPU: torch.bmm over the flattened batch, a batch of one run as
    two (a lone product takes another kernel), which gives every member
    the bits the step paths had in batches before."""
    if a.is_cuda:
        return bmv_reduce(a, x)
    shape = torch.broadcast_shapes(a.shape[:-2], x.shape[:-1])
    m, k = a.shape[-2:]
    a3 = a.expand(*shape, m, k).reshape(-1, m, k)
    x3 = x.expand(*shape, k).reshape(-1, k, 1)
    n = a3.shape[0]
    if n == 1:
        a3, x3 = a3.expand(2, m, k), x3.expand(2, k, 1)
    return torch.bmm(a3, x3)[:n].reshape(*shape, m)


def cuda_ms(fn, reps=None):
    """Mean ms per call of fn() on the card, by CUDA events, after a warm
    call; `reps` adapts to about 0.2 s of work when not given."""
    fn()
    torch.cuda.synchronize()
    if reps is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps = int(min(50, max(3, 0.2 / max(time.perf_counter() - t0, 1e-6))))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
