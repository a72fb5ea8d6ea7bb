"""Device selection shared by every entry point of the port."""

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
