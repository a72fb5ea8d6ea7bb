"""Hopper kernel for the batched small-matrix Jacobi eigensolver.

Counterpart of `multioptpy_tpu/ops/jacobi_pallas.py`. The kernel itself is
`csrc/jacobi_eigh.cu` (one matrix per thread block, A and V in shared
memory, every rotation of a round in parallel; see the note at its top). It
is compiled with `nvcc` for sm_90a into a shared library with a C interface
at first use, keyed by a hash of the source, into `_build/` beside the
package, and loaded with ctypes. Nothing compiles at import time.

`jacobi_eigh_cuda` launches the kernel on a CUDA tensor and runs the plain
PyTorch version `jacobi_eigh_plain` (the same algorithm: circle-method
pairs, all rotations of a round in parallel, re-symmetrized once per sweep)
only on a CPU tensor. `jacobi_eigh_auto` keeps the reference's shape gate,
with the kernel's shared-memory limit as its threshold.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import torch

from multioptpy_tpu_torch.ops.jacobi import pad_to_even, sort_and_trim

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "jacobi_eigh.cu"
BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
_ENTRY = {torch.float32: "jacobi_eigh_f32", torch.float64: "jacobi_eigh_f64"}

# dynamic shared memory a Hopper block may opt into (bytes)
SMEM_LIMIT = 232448


def smem_bytes(d, itemsize):
    """Shared memory of one block at even dimension d: A, V, c, s, p, q."""
    return 2 * d * d * itemsize + (d // 2) * (2 * itemsize + 8)


def max_dim(dtype):
    """Largest even D whose block fits in shared memory (168 f32, 120 f64)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    d = 2
    while smem_bytes(d + 2, itemsize) <= SMEM_LIMIT:
        d += 2
    return d


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
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def circle_schedule(d, device=None):
    """(d-1, d/2, 2) circle-method pairs (p, q) in the kernel's order and
    orientation: index 0 is fixed, at round r seat i >= 1 holds
    1 + ((i - 1 - r) mod (d-1)), and pair k matches seats k and d-1-k."""
    m = d - 1
    k = torch.arange(d // 2, device=device)
    r = torch.arange(m, device=device)[:, None]
    q = 1 + (m - 1 - k - r + 2 * m) % m
    p = torch.where(k == 0, 0, 1 + (k - 1 - r + m) % m)
    return torch.stack([p, q], dim=-1)


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

    A CUDA tensor launches the kernel (and adds one to `launches`); a CPU
    tensor runs `jacobi_eigh_plain`. Nothing else falls back."""
    if a.device.type == "cpu":
        return jacobi_eigh_plain(a, sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"jacobi_eigh_cuda: unsupported device {a.device}")
    if a.dtype not in _ENTRY:
        raise TypeError(f"jacobi_eigh_cuda: float32 or float64, not {a.dtype}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"jacobi_eigh_cuda: square matrices, not {a.shape}")
    a3, d0, batch_shape = pad_to_even(a)
    a3 = a3.contiguous()
    b, d, _ = a3.shape
    if d > max_dim(a.dtype):
        raise ValueError(f"jacobi_eigh_cuda: D={d} exceeds the shared-memory "
                         f"limit {max_dim(a.dtype)} for {a.dtype}")
    w = torch.empty((b, d), dtype=a.dtype, device=a.device)
    v = torch.empty((b, d, d), dtype=a.dtype, device=a.device)
    if b:
        fn = getattr(_library(), _ENTRY[a.dtype])
        with torch.cuda.device(a.device):
            rc = fn(a3.data_ptr(), w.data_ptr(), v.data_ptr(), b, d,
                    int(sweeps), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"jacobi_eigh kernel launch failed: "
                               f"cudaError {rc}")
        jacobi_eigh_cuda.launches += 1
    return sort_and_trim(w, v, d0, batch_shape)


jacobi_eigh_cuda.launches = 0


def jacobi_eigh_auto(h, sweeps=7):
    """`jacobi_eigh_cuda` below the kernel's shared-memory limit,
    torch.linalg.eigh above it (the reference's shape gate, at the Hopper
    kernel's own limit rather than the TPU crossover)."""
    d = h.shape[-1] + h.shape[-1] % 2
    if d > max_dim(h.dtype):
        return torch.linalg.eigh(h)
    return jacobi_eigh_cuda(h, sweeps)
