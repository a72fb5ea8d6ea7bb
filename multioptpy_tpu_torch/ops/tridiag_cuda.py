"""K3: the batched f64 symmetric eigensolver past K1's shared-memory gate.

LAPACK's dsyev in stages, each over the whole batch at once, in
`csrc/tridiag_eigh.cu` (see the note at its top): `sytrd` reduces each
matrix to tridiagonal form by Householder reflectors, `ormtr` forms Q from
them, and `steqr` runs implicit-shift QL/QR on the tridiagonal (d, e) in
one thread a matrix, records each sweep's rotations, and applies them to
Q's rows (Z = Q G1 G2 ...), the eigenpairs sorted ascending as
torch.linalg.eigh returns them. The chain stops when a matrix's rotation
record is full and resumes after the record has been applied, so a call
runs one or more rounds of (chain, apply) and reads one status a round.

`ops/cuda_build.py` compiles the library at first use and it is loaded
with ctypes. Nothing compiles at import time.

`tridiag_eigh_cuda` launches the kernels on a CUDA tensor and runs the
plain PyTorch version `tridiag_eigh_plain` (the same stages, the same
chain with the same record and rounds) only on a CPU tensor. `launch`
counts the kernels it launches, by stage. Which calls come here is
`ops/eigh64.plan`'s choice.
"""

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from multioptpy_tpu_torch.logging_utils import count_eigh
from multioptpy_tpu_torch.ops.cuda_build import (CSRC, SMEM_LIMIT, build,
                                                 device_index)

SOURCE = CSRC / "tridiag_eigh.cu"

# the kernels' constants (csrc/tridiag_eigh.cu)
CHUNK = 32          # sytrd: rows and columns of a tile of the trailing matrix
ORMTR_COLS = 32     # ormtr: columns of Q one block forms
ORMTR_THREADS = 256
APPLY_ROWS = 32     # steqr apply: rows of Q one block (one warp) rotates
# ormtr and apply split a batch into grids of at most this many matrices
MAX_GRID_Y = 65535
STAGES = ("sytrd", "ormtr", "steqr_chain", "steqr_apply")
# a matrix's chain state: (phase, l1, l, lend, jtot, status, sweeps, rotations)
PHASE, L1, L, LEND, JTOT, STATUS, SWEEPS, ROTATIONS = range(8)
STATE_LEN = 8
NEW_BLOCK, QL, QR = 0, 1, 2
RUNNING, FINISHED, DONE_BEFORE, FAILED = 0, 1, 2, 3
# LAPACK's dlamch('E') and dlamch('S') in float64; dsteqr's iteration cap
EPS = 2.0 ** -53
SAFMIN = 2.2250738585072014e-308
MAXIT = 30


def smem_bytes(n):
    """Dynamic shared memory of one block of each kernel at order n (f64):
    sytrd's four vectors and a reduction buffer; ormtr's n x 32 tile of Q,
    two reflectors, the partial dots and the 32 weights; apply's n x 33
    tile of rows (padded) and one sweep's (c, s)."""
    return {"sytrd": (4 * n + 32) * 8,
            "ormtr": (n * ORMTR_COLS + 2 * n + (ORMTR_THREADS // 32 + 1)
                      * ORMTR_COLS) * 8,
            "apply": (n * (APPLY_ROWS + 1) + 2 * n) * 8}


@lru_cache(maxsize=None)
def max_dim():
    """Largest order whose blocks fit in shared memory (830 in f64)."""
    n = 1
    while max(smem_bytes(n + 1).values()) <= SMEM_LIMIT:
        n += 1
    return n


def record_capacity(n):
    """Rotations and sweeps one matrix may record in a round: n^2 and 3 n
    (a sweep is at most n - 1 rotations). The chain records 0.78 n^2
    rotations in 1.6 n sweeps on C32H66's band (n = 392), 0.89-0.97 n^2
    on SPD matrices and 1.08-1.12 n^2 in 2.1 n sweeps on random symmetric
    ones (n = 122-392); a chain whose record is full stops and resumes in
    the next round."""
    return n * n, 3 * n


# ---------------------------------------------------------------- plain


def sytrd_plain(a):
    """Householder reduction of symmetric (B, n, n) a to tridiagonal form,
    LAPACK's dsytd2 (uplo "L"): returns d (B, n), e (B, n; e[n-1] = 0),
    tau (B, n) and the reflectors (B, n, n), row i holding v_i (v_i[i+1] =
    1, entries i+2.. below the subdiagonal, zero elsewhere)."""
    a = a.clone()
    bsz, n, _ = a.shape
    d = a.new_zeros(bsz, n)
    e = a.new_zeros(bsz, n)
    tau = a.new_zeros(bsz, n)
    refl = a.new_zeros(bsz, n, n)
    for i in range(n - 1):
        alpha = a[:, i + 1, i].clone()
        x = a[:, i + 2:, i]
        ss = (x * x).sum(-1)
        has = ss > 0
        beta = torch.where(has, -torch.copysign(torch.sqrt(alpha * alpha + ss),
                                                alpha), alpha)
        t = torch.where(has, (beta - alpha) / beta, torch.zeros_like(alpha))
        scale = torch.where(has, 1.0 / (alpha - beta), torch.zeros_like(alpha))
        v = a.new_zeros(bsz, n - i - 1)
        v[:, 0] = 1.0
        v[:, 1:] = x * scale[:, None]
        refl[:, i, i + 1:] = v
        d[:, i], e[:, i], tau[:, i] = a[:, i, i], beta, t
        trail = a[:, i + 1:, i + 1:]
        p = t[:, None] * (trail @ v[..., None])[..., 0]
        alpha2 = -0.5 * t * (p * v).sum(-1)
        w = p + alpha2[:, None] * v
        a[:, i + 1:, i + 1:] = trail - v[:, :, None] * w[:, None, :] \
            - w[:, :, None] * v[:, None, :]
    d[:, n - 1] = a[:, n - 1, n - 1]
    return d, e, tau, refl


def ormtr_plain(refl, tau):
    """Q = H(0) H(1) ... H(n-2), H(i) = I - tau_i v_i v_i^T, accumulated
    backwards from I (LAPACK's dorgtr): (B, n, n)."""
    bsz, n, _ = refl.shape
    q = torch.eye(n, dtype=refl.dtype, device=refl.device).repeat(bsz, 1, 1)
    for i in range(n - 2, -1, -1):
        v = refl[:, i, i + 1:]
        blk = q[:, i + 1:, i + 1:]
        wv = tau[:, i, None] * (v[:, None, :] @ blk)[:, 0]
        q[:, i + 1:, i + 1:] = blk - v[:, :, None] * wv[:, None, :]
    return q


def _lartg(f, g):
    """LAPACK's dlartg (3.10): c, s, r with [c s; -s c] [f; g] = [r; 0],
    from one reciprocal square root."""
    if g == 0.0:
        return 1.0, 0.0, f
    if f == 0.0:
        return 0.0, math.copysign(1.0, g), abs(g)
    q = f * f + g * g
    inv = 1.0 / math.sqrt(q)
    return abs(f) * inv, math.copysign(inv, f) * g, math.copysign(q * inv, f)


def _laev2(a, b, c):
    """LAPACK's dlaev2: the eigensystem of [[a, b], [b, c]], rt1 the
    larger in magnitude, (cs1, sn1) its unit eigenvector."""
    sm, df = a + c, a - c
    adf, tb = abs(df), b + b
    ab = abs(tb)
    acmx, acmn = (a, c) if abs(a) > abs(c) else (c, a)
    if adf > ab:
        rt = adf * math.sqrt(1.0 + (ab / adf) ** 2)
    elif adf < ab:
        rt = ab * math.sqrt(1.0 + (adf / ab) ** 2)
    else:
        rt = ab * math.sqrt(2.0)
    if sm < 0.0:
        rt1, sgn1 = 0.5 * (sm - rt), -1
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b
    elif sm > 0.0:
        rt1, sgn1 = 0.5 * (sm + rt), 1
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b
    else:
        rt1, rt2, sgn1 = 0.5 * rt, -0.5 * rt, 1
    if df >= 0.0:
        cs, sgn2 = df + rt, 1
    else:
        cs, sgn2 = df - rt, -1
    if abs(cs) > ab:
        ct = -tb / cs
        sn1 = 1.0 / math.sqrt(1.0 + ct * ct)
        cs1 = ct * sn1
    elif ab == 0.0:
        cs1, sn1 = 1.0, 0.0
    else:
        tn = -cs / tb
        cs1 = 1.0 / math.sqrt(1.0 + tn * tn)
        sn1 = tn * cs1
    if sgn1 == sgn2:
        cs1, sn1 = -sn1, cs1
    return rt1, rt2, cs1, sn1


def steqr_chain(d, e, st, cap, scap, perm):
    """One round of the kernel's scalar chain on one matrix: LAPACK's
    dsteqr (compz "V") on the lists d (n) and e (n - 1 used), resumed from
    and left in the state list st. Returns the round's record: sweeps
    [(lo, count, backward, offset)] over columns lo .. lo + count and their
    rotations in the order they apply, from cs[offset]: the k-th takes
    columns (j, j + 1), j = lo + count - 1 - k backward, lo + k forward,
    and is recorded as (c, dj s), s its sine in dlasr and dj = -1
    backward, +1 forward (see `apply_sweeps`). The chain stops
    before a sweep the record has no room for (status RUNNING); at its end
    it sorts d ascending and perm with it (status FINISHED)."""
    sweeps, cs = [], []
    if st[STATUS] == FINISHED:
        st[STATUS] = DONE_BEFORE
    if st[STATUS] != RUNNING:
        st[SWEEPS] = st[ROTATIONS] = 0
        return sweeps, cs
    n = len(d)
    eps2 = EPS * EPS
    nmaxit = MAXIT * n

    def room(k):
        return len(cs) + k <= cap and len(sweeps) < scap

    while True:
        if st[PHASE] == NEW_BLOCK:
            l1 = st[L1]
            if l1 > n - 1:
                for i in range(n - 1):      # dsteqr's selection sort
                    k, p = i, d[i]
                    for j in range(i + 1, n):
                        if d[j] < p:
                            k, p = j, d[j]
                    if k != i:
                        d[k], d[i] = d[i], p
                        perm[i], perm[k] = perm[k], perm[i]
                st[STATUS] = FINISHED
                break
            if l1 > 0:
                e[l1 - 1] = 0.0
            m = l1
            while m < n - 1:
                tst = abs(e[m])
                if tst == 0.0:
                    break
                if tst <= (math.sqrt(abs(d[m])) * math.sqrt(abs(d[m + 1]))
                           * EPS):
                    e[m] = 0.0
                    break
                m += 1
            l, lend = l1, m
            st[L1] = m + 1
            if lend == l:
                continue
            if abs(d[lend]) < abs(d[l]):
                l, lend = lend, l
            st[L], st[LEND] = l, lend
            st[PHASE] = QL if lend > l else QR
            continue
        l, lend = st[L], st[LEND]
        ended = False
        if st[PHASE] == QL:
            m = l
            while m < lend and (abs(e[m]) ** 2
                                > (eps2 * abs(d[m])) * abs(d[m + 1]) + SAFMIN):
                m += 1
            if m < lend:
                e[m] = 0.0
            p = d[l]
            if m == l:
                l += 1
                ended = l > lend
            elif m == l + 1:
                if not room(1):
                    break
                rt1, rt2, c, s = _laev2(d[l], e[l], d[l + 1])
                sweeps.append((l, 1, 1, len(cs)))
                cs.append((c, -s))
                d[l], d[l + 1], e[l] = rt1, rt2, 0.0
                l += 2
                ended = l > lend
            elif st[JTOT] == nmaxit:
                ended = True
            else:
                if not room(m - l):
                    break
                st[JTOT] += 1
                g = (d[l + 1] - p) / (2.0 * e[l])
                r = math.hypot(g, 1.0)
                g = d[m] - p + (e[l] / (g + math.copysign(r, g)))
                s = c = 1.0
                p = 0.0
                rec = []
                for i in range(m - 1, l - 1, -1):
                    f, b = s * e[i], c * e[i]
                    c, s, r = _lartg(g, f)
                    if i != m - 1:
                        e[i + 1] = r
                    g = d[i + 1] - p
                    r = (d[i] - g) * s + 2.0 * c * b
                    p = s * r
                    d[i + 1] = g + p
                    g = c * r - b
                    rec.append((c, s))
                d[l] -= p
                e[l] = g
                sweeps.append((l, m - l, 1, len(cs)))
                cs.extend(rec)
        else:
            m = l
            while m > lend and (abs(e[m - 1]) ** 2
                                > (eps2 * abs(d[m])) * abs(d[m - 1]) + SAFMIN):
                m -= 1
            if m > lend:
                e[m - 1] = 0.0
            p = d[l]
            if m == l:
                l -= 1
                ended = l < lend
            elif m == l - 1:
                if not room(1):
                    break
                rt1, rt2, c, s = _laev2(d[l - 1], e[l - 1], d[l])
                sweeps.append((l - 1, 1, 0, len(cs)))
                cs.append((c, s))
                d[l - 1], d[l], e[l - 1] = rt1, rt2, 0.0
                l -= 2
                ended = l < lend
            elif st[JTOT] == nmaxit:
                ended = True
            else:
                if not room(l - m):
                    break
                st[JTOT] += 1
                g = (d[l - 1] - p) / (2.0 * e[l - 1])
                r = math.hypot(g, 1.0)
                g = d[m] - p + (e[l - 1] / (g + math.copysign(r, g)))
                s = c = 1.0
                p = 0.0
                rec = []
                for i in range(m, l):
                    f, b = s * e[i], c * e[i]
                    c, s, r = _lartg(g, f)
                    if i != m:
                        e[i - 1] = r
                    g = d[i] - p
                    r = (d[i + 1] - g) * s + 2.0 * c * b
                    p = s * r
                    d[i] = g + p
                    g = c * r - b
                    rec.append((c, s))
                d[l] -= p
                e[l - 1] = g
                sweeps.append((m, l - m, 0, len(cs)))
                cs.extend(rec)
        st[L] = l
        if ended:
            if st[JTOT] >= nmaxit:
                st[STATUS] = FAILED
                break
            st[PHASE] = NEW_BLOCK
    st[SWEEPS], st[ROTATIONS] = len(sweeps), len(cs)
    return sweeps, cs


def apply_sweeps(zt, sweeps, cs):
    """Z <- Z G1 G2 ... for the recorded sweeps, on zt = Z^T (numpy, a row
    per column of Z): a rotation (c, s) on columns (j, j + 1) takes them to
    (s t + c z_j, c t - s z_j), t = z_{j+1} (LAPACK's dlasr "R", "V"). As
    in the kernel, a sweep walks its columns in one direction (dj = +1
    forward, -1 backward), reads one column a rotation and carries the
    other: with x the carried column and y the one read, a rotation
    recorded as (c, dj s) writes c x + dj s y behind it and carries
    c y - dj s x."""
    for lo, count, backward, off in sweeps:
        dj = -1 if backward else 1
        base = lo + count - 1 if backward else lo + 1
        x = zt[base - dj].copy()
        for k in range(count):
            c, sd = cs[off + k]
            y = zt[base + dj * k]
            zt[base + dj * (k - 1)] = c * x + sd * y
            x = c * y - sd * x
        zt[base + dj * (count - 1)] = x


def tridiag_eigh_plain(a, capacity=None):
    """K3's stages in PyTorch and Python: the plain version that the CPU
    tests run and that the kernels are held against on the card. (w, v)
    ascending of symmetric a (..., n, n); `capacity` (rotations, sweeps
    a round) defaults to the kernel's `record_capacity`."""
    batch_shape, n = a.shape[:-2], a.shape[-1]
    a3 = a.reshape(-1, n, n)
    d, e, tau, refl = sytrd_plain(a3)
    q = ormtr_plain(refl, tau)
    cap, scap = capacity or record_capacity(n)
    w = torch.empty_like(d)
    v = torch.empty_like(q)
    for b in range(a3.shape[0]):
        db, eb = d[b].tolist(), e[b].tolist()
        zt = q[b].mT.cpu().numpy().copy()
        perm = list(range(n))
        st = [0] * STATE_LEN
        while st[STATUS] == RUNNING:
            sweeps, cs = steqr_chain(db, eb, st, cap, scap, perm)
            apply_sweeps(zt, sweeps, cs)
        if st[STATUS] == FAILED:
            raise RuntimeError(f"tridiag_eigh: QL did not converge in "
                               f"{MAXIT * n} sweeps (matrix {b})")
        w[b] = torch.as_tensor(db, dtype=a.dtype)
        v[b] = torch.as_tensor(np.ascontiguousarray(zt[perm].T))
    return w.reshape(*batch_shape, n), v.reshape(*batch_shape, n, n)


# ----------------------------------------------------------------- card


@lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k3_sytrd_f64.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
    lib.k3_ormtr_f64.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    lib.k3_steqr_chain_f64.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.k3_steqr_apply_f64.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.k3_allow_smem.argtypes = []
    for fn in (lib.k3_sytrd_f64, lib.k3_ormtr_f64, lib.k3_steqr_chain_f64,
               lib.k3_steqr_apply_f64, lib.k3_allow_smem):
        fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _prepare(index):
    """Once per device: ormtr and apply may take SMEM_LIMIT bytes of
    dynamic shared memory."""
    with torch.cuda.device(index):
        rc = _library().k3_allow_smem()
    if rc != 0:
        raise RuntimeError(f"tridiag_eigh: cudaFuncSetAttribute failed: "
                           f"cudaError {rc}")


def _check(rc, stage, shape):
    if rc != 0:
        raise RuntimeError(f"tridiag_eigh {stage} launch failed: "
                           f"cudaError {rc} (B, n = {shape})")


def _counted(stage, kernels):
    tridiag_eigh_cuda.launches += kernels
    tridiag_eigh_cuda.stage_launches[stage] += kernels


def reset_launches():
    """Set the total and per-stage kernel launch counts to 0."""
    tridiag_eigh_cuda.launches = 0
    tridiag_eigh_cuda.stage_launches = dict.fromkeys(STAGES, 0)


def launch(a3):
    """K3 on a contiguous (B, n, n) f64 CUDA batch: sytrd, ormtr, then
    rounds of (chain, apply) until every chain has finished; one host read
    of the statuses a round. Adds each kernel launch to
    `tridiag_eigh_cuda.launches` and `.stage_launches` (ormtr and apply
    launch once per MAX_GRID_Y matrices). Returns (w, v) ascending."""
    bsz, n, _ = a3.shape
    dev = a3.device
    _prepare(device_index(dev))
    lib = _library()
    f64 = dict(dtype=torch.float64, device=dev)
    work = a3.clone()
    d = torch.empty(bsz, n, **f64)
    e = torch.empty(bsz, n, **f64)
    tau = torch.empty(bsz, n, **f64)
    part = torch.empty(bsz, -(-n // CHUNK), n, **f64)
    v = torch.empty(bsz, n, n, **f64)
    w = torch.empty(bsz, n, **f64)
    cap, scap = record_capacity(n)
    cs = torch.empty(bsz, cap, 2, **f64)
    sweeps = torch.empty(bsz, scap, 4, dtype=torch.int32, device=dev)
    state = torch.zeros(bsz, STATE_LEN, dtype=torch.int32, device=dev)
    perm = torch.empty(bsz, n, dtype=torch.int32, device=dev)
    grids = -(-bsz // MAX_GRID_Y)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _check(lib.k3_sytrd_f64(work.data_ptr(), d.data_ptr(), e.data_ptr(),
                                tau.data_ptr(), part.data_ptr(), bsz, n,
                                stream), "sytrd", (bsz, n))
        _counted("sytrd", 1)
        _check(lib.k3_ormtr_f64(work.data_ptr(), tau.data_ptr(), v.data_ptr(),
                                bsz, n, stream), "ormtr", (bsz, n))
        _counted("ormtr", grids)
        while True:
            _check(lib.k3_steqr_chain_f64(
                d.data_ptr(), e.data_ptr(), state.data_ptr(), cs.data_ptr(),
                sweeps.data_ptr(), perm.data_ptr(), w.data_ptr(), bsz, n, cap,
                scap, stream), "steqr chain", (bsz, n))
            _counted("steqr_chain", 1)
            _check(lib.k3_steqr_apply_f64(
                v.data_ptr(), state.data_ptr(), cs.data_ptr(),
                sweeps.data_ptr(), perm.data_ptr(), bsz, n, cap, scap,
                stream), "steqr apply", (bsz, n))
            _counted("steqr_apply", grids)
            status = state[:, STATUS].cpu()
            failed = status.eq(FAILED).nonzero()[:, 0].tolist()
            if failed:
                raise RuntimeError(f"tridiag_eigh: QL did not converge in "
                                   f"{MAXIT * n} sweeps (matrices {failed})")
            if not (status == RUNNING).any():
                break
    return w, v


def tridiag_eigh_cuda(a):
    """Eigendecomposition of symmetric a (..., n, n), ascending: returns
    (w, v) with a = v @ diag(w) @ v.T. f64, n up to `max_dim`.

    A CUDA tensor launches K3 (`launch`, which counts its kernel launches
    in `launches` and `stage_launches`); a CPU tensor runs
    `tridiag_eigh_plain`. Nothing else falls back."""
    if a.device.type == "cpu":
        count_eigh("cpu", a)
        return tridiag_eigh_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"tridiag_eigh_cuda: unsupported device {a.device}")
    if a.dtype != torch.float64:
        raise TypeError(f"tridiag_eigh_cuda: float64, not {a.dtype}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"tridiag_eigh_cuda: square matrices, not {a.shape}")
    batch_shape, n = a.shape[:-2], a.shape[-1]
    if n > max_dim():
        raise ValueError(f"tridiag_eigh_cuda: n={n} exceeds the shared-memory "
                         f"limit {max_dim()}")
    a3 = a.reshape(-1, n, n).contiguous()
    if a3.shape[0] == 0:
        return a.new_empty(*batch_shape, n), a.new_empty(*batch_shape, n, n)
    w, v = launch(a3)
    count_eigh("k3", a3)
    return w.reshape(*batch_shape, n), v.reshape(*batch_shape, n, n)


reset_launches()
