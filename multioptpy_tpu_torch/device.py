"""Device selection shared by every entry point of the port, and the card
timer its scripts share."""

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
