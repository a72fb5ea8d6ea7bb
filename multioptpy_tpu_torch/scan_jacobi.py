#!/usr/bin/env python3
"""Where the Jacobi kernel's warp variant overtakes its block variant, on one
CUDA card.

Run from the repository root:  python3 -m multioptpy_tpu_torch.scan_jacobi

At D = 24 and 32 (slice A's RFO step and SQM band), in f32 and f64, and
batches from 256 to 12288 random symmetric matrices, 7 sweeps, it times each
variant (the kernel launch alone, without the wrapper's sort; CUDA events
over repeated calls after a warm call) and torch.linalg.eigh, and prints one
JSON line per (dtype, D, B) with the variant `launch_plan` picks for the
card, then the card's name and power limit. Each variant is forced through
`launch_plan` itself: an SM count of 0 makes every batch fill the card (the
warp variant), one of B makes none do (the block variant). The warp
variant's threshold, WARP_MIN_BATCH_PER_SM in ops/jacobi_cuda.py, is read
from these lines.
"""

import json
import subprocess

import torch

from multioptpy_tpu_torch.device import cuda_ms, resolve_device
from multioptpy_tpu_torch.ops import jacobi_cuda as jc

BATCHES = (256, 528, 1056, 1584, 2112, 4224, 12288)
SWEEPS = 7


def main():
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        for d in (24, 32):
            for b in BATCHES:
                m = torch.randn(b, d, d, generator=gen, dtype=torch.float64)
                a = (0.5 * (m + m.mT)).to(dtype).to(dev)
                warp = jc.launch_plan(b, d, dtype, sm_count=0)
                block = jc.launch_plan(b, d, dtype, sm_count=b)
                print(json.dumps({
                    "d": d, "batch": b, "dtype": str(dtype).split(".")[-1],
                    "sweeps": SWEEPS,
                    "picked": jc.launch_plan(b, d, dtype, sm_count).variant,
                    "warp_ms": cuda_ms(lambda: jc.launch(a, SWEEPS, warp),
                                       reps=10),
                    "block_ms": cuda_ms(lambda: jc.launch(a, SWEEPS, block),
                                        reps=10),
                    "library_ms": cuda_ms(lambda: torch.linalg.eigh(a),
                                          reps=3),
                    "card": card}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
