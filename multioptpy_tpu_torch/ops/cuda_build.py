"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled with `nvcc` for sm_90a into a shared library with a
C interface at first use, keyed by a hash of the source and the flags, into
`_build/` beside the package; the kernel modules (`ops/jacobi_cuda.py`,
`ops/tridiag_cuda.py`) load it with ctypes. Nothing compiles at import
time.
"""

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# dynamic shared memory a Hopper block may opt into (bytes)
SMEM_LIMIT = 232448


def build(source):
    """Compile the kernel library of `source` (a file of `csrc/`) if it
    has not been built yet. Returns (path, compiler log); the log is empty
    when it was cached."""
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}_{key}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, str(source)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{out.stderr}")
        os.replace(tmp, lib_path)   # atomic: concurrent builds cannot clash
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, out.stderr


def device_index(device):
    """The CUDA device index of `device`, the current one if it has none."""
    return device.index if device.index is not None else \
        torch.cuda.current_device()
