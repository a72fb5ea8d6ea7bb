#!/usr/bin/env python3
"""The crossovers of the eigensolver kernels (K1, K3) on one CUDA card.

Run from the repository root:

    python3 -m multioptpy_tpu_torch.scan_jacobi              # the variants
    python3 -m multioptpy_tpu_torch.scan_jacobi --crossover  # K1, K3 or library

Without arguments: where the kernel's warp variant overtakes its block
variant. At D = 24 and 32 (slice A's RFO step and SQM band), in f32 and f64,
and batches from 256 to 12288 random symmetric matrices, 7 sweeps, it times
each variant (the kernel launch alone, without the wrapper's sort; CUDA
events over repeated calls after a warm call) and torch.linalg.eigh, and
prints one JSON line per (dtype, D, B) with the variant `launch_plan` picks
for the card, then the card's name and power limit. Each variant is forced
through `launch_plan` itself: an SM count of 0 makes every batch fill the
card (the warp variant), one of B makes none do (the block variant). The
warp variant's threshold, WARP_MIN_BATCH_PER_SM in ops/jacobi_cuda.py, is
read from these lines.

With --crossover: from which batch `eigh_fast` should send a call to K1.
In f64 at D = 20, 28, 54, 56, 72, 78, 80, 100, 104 and 120 and in f32 at
D = 24 and 32, at B = 1, 2, 3, 4, 6, 8 and 16 random symmetric matrices, it
times the wrapper `jacobi_eigh_cuda` (padding and sort included) at the
route's sweep count (`eigh64.k1_sweeps`) and torch.linalg.eigh (the median
of three CUDA-event means each), one JSON line per (dtype, D, B), then one
line per (dtype, D) with `b_min`: the smallest scanned batch from which K1
is faster at every larger scanned batch (null if at none), beside the
batch the route takes there (`eigh64.b_min`: the entry of
EIGH_MIN_BATCH, or between two entries the larger). Then the same past
K1's gate for K3 (`tridiag_cuda.tridiag_eigh_cuda`): f64 at D = 122, 200,
294 and 392 and B = 1, 2, 3, 4, 6, 8, 16 and 588, one line per (D, B) and
one per D with `b_min3` beside the batch the route takes there
(`eigh64.b_min` by `eigh64.K3_MIN_BATCH`). A
call that takes over 0.1 s is timed once after a warm call, three times.
"""

import argparse
import json
import statistics
import subprocess

import torch

from multioptpy_tpu_torch.device import cuda_ms, resolve_device
from multioptpy_tpu_torch.ops import jacobi_cuda as jc
from multioptpy_tpu_torch.ops import tridiag_cuda as tc
from multioptpy_tpu_torch.ops.eigh64 import K3_MIN_BATCH, b_min, k1_sweeps

BATCHES = (256, 528, 1056, 1584, 2112, 4224, 12288)
SWEEPS = 7
CROSSOVER_DIMS = {torch.float64: (20, 28, 54, 56, 72, 78, 80, 100, 104,
                                   120),
                  torch.float32: (24, 32)}
CROSSOVER_BATCHES = (1, 2, 3, 4, 6, 8, 16)
K3_DIMS = (122, 200, 294, 392)
K3_BATCHES = (1, 2, 3, 4, 6, 8, 16, 588)


def _random_sym(gen, b, d, dtype, dev):
    m = torch.randn(b, d, d, generator=gen, dtype=torch.float64)
    return (0.5 * (m + m.mT)).to(dtype).to(dev)


def _dtype_name(dtype):
    return str(dtype).split(".")[-1]


def scan_variants(dev, card, gen):
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        for d in (24, 32):
            for b in BATCHES:
                a = _random_sym(gen, b, d, dtype, dev)
                warp = jc.launch_plan(b, d, dtype, sm_count=0)
                block = jc.launch_plan(b, d, dtype, sm_count=b)
                print(json.dumps({
                    "d": d, "batch": b, "dtype": _dtype_name(dtype),
                    "sweeps": SWEEPS,
                    "picked": jc.launch_plan(b, d, dtype, sm_count).variant,
                    "warp_ms": cuda_ms(lambda: jc.launch(a, SWEEPS, warp),
                                       reps=10),
                    "block_ms": cuda_ms(lambda: jc.launch(a, SWEEPS, block),
                                        reps=10),
                    "library_ms": cuda_ms(lambda: torch.linalg.eigh(a),
                                          reps=3),
                    "card": card}), flush=True)


def scan_crossover(dev, card, gen):
    for dtype, dims in CROSSOVER_DIMS.items():
        for d in dims:
            sweeps = k1_sweeps(d, dtype)
            k1_wins = []
            for b in CROSSOVER_BATCHES:
                a = _random_sym(gen, b, d, dtype, dev)
                k1 = statistics.median(
                    cuda_ms(lambda: jc.jacobi_eigh_cuda(a, sweeps))
                    for _ in range(3))
                lib = statistics.median(
                    cuda_ms(lambda: torch.linalg.eigh(a)) for _ in range(3))
                k1_wins.append(k1 < lib)
                print(json.dumps({
                    "d": d, "batch": b, "dtype": _dtype_name(dtype),
                    "sweeps": sweeps, "k1_ms": k1, "library_ms": lib,
                    "card": card}), flush=True)
            print(json.dumps({
                "d": d, "dtype": _dtype_name(dtype), "sweeps": sweeps,
                "b_min": _first_winning(CROSSOVER_BATCHES, k1_wins),
                "table": b_min(d, dtype), "card": card}),
                flush=True)


def _median_ms(fn):
    """The median of three CUDA-event means of fn (one call each, after a
    warm one, where a call takes over 0.1 s)."""
    reps = 1 if cuda_ms(fn, reps=1) > 100.0 else None
    return statistics.median(cuda_ms(fn, reps=reps) for _ in range(3))


def _first_winning(batches, wins):
    """The smallest batch from which K wins at every larger one, or None."""
    wins_from = [b for i, b in enumerate(batches) if all(wins[i:])]
    return wins_from[0] if wins_from else None


def scan_k3(dev, card, gen):
    for d in K3_DIMS:
        k3_wins = []
        for b in K3_BATCHES:
            a = _random_sym(gen, b, d, torch.float64, dev)
            k3 = _median_ms(lambda: tc.tridiag_eigh_cuda(a))
            lib = _median_ms(lambda: torch.linalg.eigh(a))
            k3_wins.append(k3 < lib)
            print(json.dumps({"d": d, "batch": b, "dtype": "float64",
                              "k3_ms": k3, "library_ms": lib, "card": card}),
                  flush=True)
        print(json.dumps({"d": d, "dtype": "float64",
                          "b_min3": _first_winning(K3_BATCHES, k3_wins),
                          "table": b_min(d, torch.float64, K3_MIN_BATCH),
                          "card": card}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--crossover", action="store_true",
                        help="K1, then K3, against torch.linalg.eigh at "
                             "small batches")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    if args.crossover:
        scan_crossover(dev, card, gen)
        scan_k3(dev, card, gen)
    else:
        scan_variants(dev, card, gen)
    print(card)


if __name__ == "__main__":
    main()
