"""Hopper kernel for the batched small-matrix Jacobi eigensolver.

Counterpart of `multioptpy_tpu/ops/jacobi_pallas.py`. The kernel itself is
`csrc/jacobi_eigh.cu`, in two variants behind one wrapper: a warp per
matrix for D <= 32 at batches that fill the card, a block per matrix
otherwise, both with one fused pass over the round's 2x2 blocks (see the
note at its top). It is compiled with
`nvcc` for sm_90a into a shared library with a C interface at first use,
keyed by a hash of the source, into `_build/` beside the package, and
loaded with ctypes. Nothing compiles at import time.

`jacobi_eigh_cuda` launches the kernel on a CUDA tensor and runs the plain
PyTorch version `jacobi_eigh_plain` (the same algorithm: circle-method
pairs, all rotations of a round in parallel, re-symmetrized once per sweep)
only on a CPU tensor; `launch` is its raw launch by a given plan (the
scan of the variants' crossover forces one). `launch_plan`,
`pair_indices`, `thread_blocks` and
`symmetrize_pairs` repeat the kernel's index arithmetic and launch shape in
Python, so that the CPU tests can check them. `jacobi_eigh_auto` keeps the
reference's shape gate, with the kernel's shared-memory limit as its
threshold.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from multioptpy_tpu_torch.ops.jacobi import pad_to_even, sort_and_trim

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "jacobi_eigh.cu"
BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
VARIANTS = ("warp", "block")

# dynamic shared memory a Hopper block may opt into (bytes)
SMEM_LIMIT = 232448
# the kernel's constants (csrc/jacobi_eigh.cu)
WARP_MAX_D = 32
WARP_LD = 32
MAX_WARPS_PER_BLOCK = 4
H100_SMS = 132
# the warp variant takes D <= 32 from this many matrices per SM up; below
# it, one block per matrix finishes sooner. Measured in f32 at D = 24 and
# 32 (scan_jacobi) and applied to f64 too, where the same scan puts the
# crossover elsewhere: at D = 32 from 8 matrices per SM, at D = 24 beyond
# the largest batch scanned (PERF.md, section 6)
WARP_MIN_BATCH_PER_SM = 12


class LaunchPlan(NamedTuple):
    variant: str     # "warp" or "block"
    grid: int        # blocks
    threads: int     # threads per block
    smem: int        # dynamic shared memory per block, bytes


def block_lda(d, itemsize):
    """Row stride of the block variant's upper-triangle A: d + 1 (rows and
    columns free of bank conflicts) where it fits, else d."""
    fits = (d * (d + 1) + d * d + 2 * d) * itemsize <= SMEM_LIMIT
    return d + 1 if fits else d


def smem_bytes(d, itemsize):
    """Shared memory of one block-variant block at even d: A (d x lda),
    V transposed (d x d) and two rounds' (c, s)."""
    return (d * block_lda(d, itemsize) + d * d + 2 * d) * itemsize


def warp_smem_bytes(d, itemsize, warps):
    """Shared memory of one warp variant block: A and V per warp, row
    stride WARP_LD."""
    return warps * 2 * d * WARP_LD * itemsize


@lru_cache(maxsize=None)
def max_dim(dtype):
    """Largest even D whose block fits in shared memory (168 f32, 120 f64)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    d = 2
    while smem_bytes(d + 2, itemsize) <= SMEM_LIMIT:
        d += 2
    return d


def launch_plan(b, d, dtype, sm_count=H100_SMS):
    """The variant and launch shape of a (b, d, d) batch, d even.

    D <= 32 with at least WARP_MIN_BATCH_PER_SM matrices per SM: the warp
    variant, 4 matrices (warps) a block. Otherwise the block variant, one
    matrix a block: G groups of d/2 threads for the A update (as few blocks
    per thread as 1024 threads allow), rounded up to whole warps, and at
    least one group of V workers beside the angle warps."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if d <= WARP_MAX_D and b >= WARP_MIN_BATCH_PER_SM * sm_count:
        warps = MAX_WARPS_PER_BLOCK
        return LaunchPlan("warp", -(-b // warps), 32 * warps,
                          warp_smem_bytes(d, itemsize, warps))
    half = d // 2
    per_thread = -(-half // (1024 // half))
    groups = -(-half // per_thread)
    angle_warps = -(-half // 32)
    threads = max(32 * -(-groups * half // 32), 32 * (angle_warps + angle_warps))
    return LaunchPlan("block", b, threads, smem_bytes(d, itemsize))


def pair_indices(k, r, d):
    """(p, q) of pair k at round r, as the kernel's `pair_of` computes them:
    index 0 fixed, seat i >= 1 holds 1 + ((i - 1 - r) mod (d-1)), pair k
    matches seats k and d-1-k; each offset wraps with one add. Ints or
    integer tensors."""
    m = d - 1
    x = k - 1 - r
    x = x + (x < 0) * m
    p = (k != 0) * (1 + x)
    y = m - 1 - k - r
    q = 1 + y + (y < 0) * m
    return p, q


def circle_schedule(d, device=None):
    """(d-1, d/2, 2) circle-method pairs (p, q) in the kernel's order and
    orientation."""
    k = torch.arange(d // 2, device=device)
    r = torch.arange(d - 1, device=device)[:, None]
    p, q = pair_indices(k, r, d)
    return torch.stack([p, q], dim=-1)


def thread_blocks(d, threads, phase="a"):
    """What each thread of one matrix owns in the A update (phase "a") or
    the V update ("v") of a round, in the kernel's walk: a (n, 4) long
    tensor of rows (thread, k, l, swapped) -- block (k, l), rows
    {p_k, q_k} x columns {p_l, q_l} -- or, for the block variant's V update,
    (thread, l, c, 0): rows p_l, q_l of V transposed, columns 2c and 2c + 1.

    Warp variant (threads = 32), both phases: lane = 16 * upper + l takes
    k = 2i + upper, and upper lanes take columns (q_l, p_l) with s_l
    negated. Block variant: G = n // (d/2) groups of the n threads from t0
    (A: all threads, t0 = 0; V: those of warps without an angle thread,
    t0 = 32 ceil(d/64)); thread t0 + g (d/2) + j takes (g + iG, j) for
    g + iG <= j in the A update (the upper triangle), every g + iG < d/2
    in the V update."""
    half = d // 2
    if threads == 32:
        lane = torch.arange(32)
        upper, l = lane // 16, lane % 16
        i = torch.arange((half + 1) // 2)[:, None]
        k = 2 * i + upper
        keep = (k < half) & (l < half)
        cols = [lane.expand_as(k), k, l.expand_as(k), upper.expand_as(k)]
        return torch.stack([c[keep] for c in cols], dim=-1)
    t0 = 0 if phase == "a" else 32 * -(-half // 32)
    groups = (threads - t0) // half
    g = torch.arange(groups)[:, None, None]
    i = torch.arange(-(-half // groups))[None, :, None]
    j = torch.arange(half)[None, None, :]
    k = g + i * groups
    k, j, g = torch.broadcast_tensors(k, j, g)
    keep = (k <= j) if phase == "a" else (k < half)
    t = t0 + g * half + j
    return torch.stack([t[keep], k[keep], j[keep], torch.zeros_like(t[keep])],
                       dim=-1)


def symmetrize_pairs(d):
    """(i, j) of the once-a-sweep re-symmetrization in the kernel's order:
    for delta = 1 .. d/2, every i < d with j = (i + delta) mod d (at
    delta = d/2 only i < d/2)."""
    half = d // 2
    delta = torch.arange(1, half + 1)[:, None]
    i = torch.arange(d)[None, :]
    keep = (delta < half) | (i < half)
    i, delta = i.expand(half, d)[keep], delta.expand(half, d)[keep]
    return torch.stack([i, (i + delta) % d], dim=-1)


def build():
    """Compile the kernel library if this source has not been built yet.
    Returns (path, compiler log); the log is empty when it was cached."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"jacobi_eigh_{key}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{out.stderr}")
        os.replace(tmp, lib_path)   # atomic: concurrent builds cannot clash
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, out.stderr


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    for variant in VARIANTS:
        for tag in _DTYPE_TAG.values():
            fn = getattr(lib, f"jacobi_eigh_{variant}_{tag}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.jacobi_eigh_allow_smem.argtypes = [ctypes.c_int]
    lib.jacobi_eigh_allow_smem.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _prepare(device_index, dtype):
    """Once per device and dtype: both variants may take SMEM_LIMIT bytes
    of dynamic shared memory. Returns the device's SM count."""
    with torch.cuda.device(device_index):
        rc = _library().jacobi_eigh_allow_smem(int(dtype == torch.float64))
    if rc != 0:
        raise RuntimeError(f"jacobi_eigh: cudaFuncSetAttribute failed: "
                           f"cudaError {rc}")
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def jacobi_eigh_plain(a, sweeps=7):
    """The kernel's algorithm in PyTorch: the plain version that the CPU
    tests run and that the kernel is held against on the card."""
    a, d0, batch_shape = pad_to_even(a)
    b, d, _ = a.shape
    a = a.clone()
    v = torch.eye(d, dtype=a.dtype, device=a.device).expand(b, d, d).clone()
    sched = circle_schedule(d, a.device)
    for _ in range(sweeps):
        for r in range(d - 1):
            p, q = sched[r, :, 0], sched[r, :, 1]
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            small = apq.abs() < 1e-30
            tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
            sgn = torch.where(tau >= 0.0, 1.0, -1.0).to(a.dtype)
            t = -sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c                                   # (B, d/2)
            cr, sr = c[..., None], s[..., None]
            rp, rq = a[:, p, :], a[:, q, :]
            a[:, p, :] = cr * rp + sr * rq
            a[:, q, :] = -sr * rp + cr * rq
            cc, sc = c[:, None, :], s[:, None, :]
            for m in (a, v):
                cp, cq = m[:, :, p], m[:, :, q]
                m[:, :, p] = cc * cp + sc * cq
                m[:, :, q] = -sc * cp + cc * cq
        a = 0.5 * (a + a.mT)
    return sort_and_trim(torch.diagonal(a, dim1=-2, dim2=-1), v, d0,
                         batch_shape)


def jacobi_eigh_cuda(a, sweeps=7):
    """Eigendecomposition of symmetric a (..., D, D), ascending: returns
    (w, v) with a = v @ diag(w) @ v.T. f32 or f64, D up to `max_dim`.

    A CUDA tensor launches the variant `launch_plan` picks (and adds one to
    `launches` and to `variant_launches[variant]`); a CPU tensor runs
    `jacobi_eigh_plain`. Nothing else falls back."""
    if a.device.type == "cpu":
        return jacobi_eigh_plain(a, sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"jacobi_eigh_cuda: unsupported device {a.device}")
    if a.dtype not in _DTYPE_TAG:
        raise TypeError(f"jacobi_eigh_cuda: float32 or float64, not {a.dtype}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"jacobi_eigh_cuda: square matrices, not {a.shape}")
    a3, d0, batch_shape = pad_to_even(a)
    a3 = a3.contiguous()
    b, d, _ = a3.shape
    if d > max_dim(a.dtype):
        raise ValueError(f"jacobi_eigh_cuda: D={d} exceeds the shared-memory "
                         f"limit {max_dim(a.dtype)} for {a.dtype}")
    plan = launch_plan(b, d, a.dtype, _prepare(_index(a3.device), a.dtype))
    w, v = launch(a3, sweeps, plan)
    return sort_and_trim(w, v, d0, batch_shape)


def _index(device):
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def launch(a3, sweeps, plan):
    """Launch the kernel as `plan` says on a contiguous CUDA (B, d, d)
    batch, d even; returns the unsorted (w, v). `jacobi_eigh_cuda` passes
    `launch_plan`'s plan for the device; the C launcher rejects a plan that
    does not fit the batch."""
    if not (a3.is_cuda and a3.is_contiguous() and a3.dtype in _DTYPE_TAG
            and a3.ndim == 3):
        raise ValueError("jacobi_cuda.launch: a contiguous (B, d, d) f32 or "
                         "f64 CUDA tensor")
    b, d, _ = a3.shape
    w = torch.empty((b, d), dtype=a3.dtype, device=a3.device)
    v = torch.empty((b, d, d), dtype=a3.dtype, device=a3.device)
    if b:
        dev = _index(a3.device)
        _prepare(dev, a3.dtype)
        fn = getattr(_library(),
                     f"jacobi_eigh_{plan.variant}_{_DTYPE_TAG[a3.dtype]}")
        with torch.cuda.device(dev):
            rc = fn(a3.data_ptr(), w.data_ptr(), v.data_ptr(), b, d,
                    int(sweeps), plan.grid, plan.threads, plan.smem,
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"jacobi_eigh {plan.variant} kernel launch "
                               f"failed: cudaError {rc} ({plan})")
        jacobi_eigh_cuda.launches += 1
        jacobi_eigh_cuda.variant_launches[plan.variant] += 1
        key = (b, d, _DTYPE_TAG[a3.dtype], int(sweeps))
        shapes = jacobi_eigh_cuda.shape_launches
        shapes[key] = shapes.get(key, 0) + 1
    return w, v


def reset_launches():
    """Set the total, per-variant and per-shape ((B, d, dtype tag,
    sweeps)) launch counts to 0."""
    jacobi_eigh_cuda.launches = 0
    jacobi_eigh_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)
    jacobi_eigh_cuda.shape_launches = {}


reset_launches()


def jacobi_eigh_auto(h, sweeps=7):
    """`jacobi_eigh_cuda` below the kernel's shared-memory limit,
    torch.linalg.eigh above it (the reference's shape gate, at the Hopper
    kernel's own limit rather than the TPU crossover)."""
    d = h.shape[-1] + h.shape[-1] % 2
    if d > max_dim(h.dtype):
        return torch.linalg.eigh(h)
    return jacobi_eigh_cuda(h, sweeps)
