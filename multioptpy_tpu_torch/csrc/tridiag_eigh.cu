// K3: batched symmetric eigensolver with eigenvectors for matrices past K1's
// shared-memory gate (D > 120 in f64), written for Hopper (sm_90a).
//
// Replaces no TPU kernel. Past its Pallas gate the JAX package leaves large
// matrices to jnp.linalg.eigh, and the port's counterpart, torch.linalg.eigh,
// runs cuSOLVER's syevd one matrix at a time: 3.7 ms and ~106 launches a
// 392 x 392 matrix on an H100, 2.1 s for the 588 band or Loewdin matrices of
// C32H66's exact Hessian. K3 solves the whole batch at once: LAPACK's dsyev
// in stages, one launch a stage, each stage over every matrix of the batch.
// The torch wrapper (ops/tridiag_cuda.py) allocates every buffer, runs the
// stages in order on PyTorch's current stream and reads one status a round.
//
//   k3_sytrd_kernel: Householder reduction to tridiagonal form (dsytd2,
//   lower), one block a matrix, the matrix in device memory (1.23 MB at
//   D = 392 does not fit in an SM). Each column fuses the previous column's
//   rank-2 update with this column's symmetric matrix-vector product, so the
//   lower triangle of the trailing matrix is read and written once a column.
//   The reflectors stay in place below the subdiagonal.
//   k3_ormtr_kernel: Q = H(0) H(1) ... H(n-2) formed from the reflectors
//   applied to I (dorgtr), backwards, one block per 32 columns of Q held in
//   shared memory: columns are independent under a product from the left.
//   k3_steqr_chain_kernel: implicit-shift QL/QR on the tridiagonal (dsteqr,
//   compz "V"), one thread a matrix with d and e in shared memory; it does
//   not touch Q but records each sweep: its first column, its rotations and
//   their direction. When the record is full it stops before the next
//   sweep and resumes in the next round; at its end it sorts the values
//   ascending with a permutation of the columns (dsteqr's selection sort).
//   k3_steqr_apply_kernel: applies the round's sweeps to Q from the right
//   (dlasr "R", "V"), one warp per 32 rows of Q held in shared memory: rows
//   are independent under a product from the right, and each row carries
//   in a register the column that the next rotation of a sweep shares. At
//   the chain's end it writes the columns in the sorted order.
//
// What bounds it on this card. Bytes: sytrd reads and writes the lower
// triangle of a shrinking trailing matrix once a column, 8/3 D^3 bytes a
// matrix (160 MB at D = 392, 94 GB for 588 matrices, 28 ms at 3.35 TB/s);
// ormtr and apply each read and write Q once a round. Operations (9 D^3 a
// matrix in all, the roofline's count; 94 GFLOP at 588 x 392 for sytrd and
// ormtr together, 1.4 ms at 67 TFLOP/s) are far below the card's rate.
// Latency: the QL chain is one dependent scalar sequence of about D^2 Givens
// rotations a matrix (a reciprocal square root each), so a matrix takes the
// chain's time whatever the batch, and small batches leave the card idle: the
// route sends a batch here only from the measured crossover
// (eigh64.K3_MIN_BATCH). The apply is bound by shared-memory traffic,
// about D^3 rotated entries a matrix. The design answers each: sytrd's fused
// pass moves two thirds of the unfused dsytd2's bytes; every block of a
// 588-matrix sytrd is resident at once (five an SM); ormtr and apply keep
// their tiles in shared memory so Q crosses device memory once a stage; all
// chains run at once, one per block.
//
// Scaling: like dsteqr without its block scaling, the chain assumes entries
// between about 1e-150 and 1e150 in magnitude (f*f + g*g in a rotation).

#include <cuda_runtime.h>

namespace {

// Shared memory a Hopper block may opt into (232,448 bytes of the SM's 256 KB).
constexpr int kMaxSmem = 232448;
constexpr int kMaxGridY = 65535;
constexpr unsigned kFullMask = 0xffffffffu;
// sytrd: rows and columns of a tile of the trailing matrix; threads and blocks
// an SM (every block of a 588-matrix batch resident; at 588 x 392 on an H100,
// 48 ms against 53-83 with 192 or 256 threads, or 4 or 6 blocks)
constexpr int kChunk = 32;
constexpr int kSytrdThreads = 128;
constexpr int kSytrdMinBlocks = 5;
// sytrd: columns of a tile a lane loads, and sums, together
constexpr int kSytrdBatch = 8;
// ormtr: columns of Q a block forms; threads
constexpr int kOrmtrCols = 32;
constexpr int kOrmtrThreads = 256;
constexpr int kOrmtrGroups = kOrmtrThreads / kOrmtrCols;
// apply: rows of Q a block (one warp) rotates; their padded stride
constexpr int kApplyRows = 32;
constexpr int kApplyLd = kApplyRows + 1;
// apply: rotations of the next sweep a lane holds (n - 1 <= 32 x 26); steps
// whose reads are issued together (at 588 x 392 on an H100: 57 ms at 16, 63
// at 8; reading the next group ahead of this one's chain ran out of
// registers, 148 ms)
constexpr int kApplyPrefetch = 26;
constexpr int kApplyGroup = 16;
// a matrix's chain state (ops/tridiag_cuda.py mirrors these)
enum { kPhase, kL1, kL, kLend, kJtot, kStatus, kSweeps, kRotations, kStateLen };
enum { kNewBlock = 0, kQL = 1, kQR = 2 };
enum { kRunning = 0, kFinished = 1, kDoneBefore = 2, kFailed = 3 };
// a recorded sweep: first column, rotations, backward (1) or forward (0), offset
constexpr int kSweepLen = 4;
constexpr int kMaxIt = 30;
// LAPACK's dlamch('E') and dlamch('S') in double
constexpr double kEps = 1.1102230246251565e-16;
constexpr double kSafmin = 2.2250738585072014e-308;

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Column sums of kB columns over a warp: t[u] holds this lane's term of
// column u. Each halving step keeps half the columns and adds the partner's
// terms of them (lane bits 16, 8, ...), then the last bits are summed out:
// lane L ends with column (L >> log2(32 / kB)) % kB. Returns column want's
// total, read from lane want * 32 / kB: kB + 5 - log2(kB) shuffles in all,
// where one warp_sum a column takes 5 kB.
template <int kB>
__device__ __forceinline__ double column_sums(double (&t)[kB], int lane, int want) {
#pragma unroll
  for (int o = 16, wd = kB; wd > 1; o >>= 1, wd >>= 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int u = 0; u < wd / 2; ++u) {
      const double send = hi ? t[u] : t[u + wd / 2];
      const double keep = hi ? t[u + wd / 2] : t[u];
      t[u] = keep + __shfl_xor_sync(kFullMask, send, o);
    }
  }
#pragma unroll
  for (int o = 16 / kB; o > 0; o >>= 1) t[0] += __shfl_xor_sync(kFullMask, t[0], o);
  return __shfl_sync(kFullMask, t[0], want * (32 / kB));
}

// Sum over the block, the same total in every thread; red holds >= 32 values.
__device__ double block_sum(double x, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.0);
}

// work: (batch, n, n), element (r, c) of the lower triangle at work[c n + r]
// (the symmetric input read column by column). On exit d, e (e[n-1] = 0),
// tau, and reflector i's v(i+2:n) at work[i n + i+2 ...] (v(i+1) = 1).
// part: (batch, ceil(n/32), n) scratch for the tiles' partial products.
__global__ void __launch_bounds__(kSytrdThreads, kSytrdMinBlocks)
    k3_sytrd_kernel(double* __restrict__ work, double* __restrict__ d_all,
                    double* __restrict__ e_all, double* __restrict__ tau_all,
                    double* __restrict__ part_all, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* v = reinterpret_cast<double*>(smem_raw);
  double* w = v + n;
  double* vp = w + n;  // the previous column's (v, w): its update is pending
  double* wp = vp + n;
  double* red = wp + n;
  const int b = blockIdx.x;
  const int nchunk = (n + kChunk - 1) / kChunk;
  double* a = work + static_cast<size_t>(b) * n * n;
  double* part = part_all + static_cast<size_t>(b) * nchunk * n;
  double* d = d_all + static_cast<size_t>(b) * n;
  double* e = e_all + static_cast<size_t>(b) * n;
  double* tau = tau_all + static_cast<size_t>(b) * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  for (int j = tid; j < n; j += nthreads) vp[j] = wp[j] = 0.0;
  __syncthreads();
  for (int i = 0; i + 1 < n; ++i) {
    // column i, rows i..n-1: the pending update, then the reflector of rows i+1..
    double* col = a + static_cast<size_t>(i) * n;
    const double vpi = vp[i], wpi = wp[i];
    double ss = 0.0;
    for (int r = i + tid; r < n; r += nthreads) {
      const double x = col[r] - vp[r] * wpi - wp[r] * vpi;
      col[r] = x;
      if (r >= i + 2) ss += x * x;
    }
    ss = block_sum(ss, red);  // its barriers publish the column
    const double alpha = col[i + 1];
    double beta = alpha, t = 0.0, scale = 0.0;
    if (ss > 0.0) {
      beta = -copysign(sqrt(alpha * alpha + ss), alpha);
      t = (beta - alpha) / beta;
      scale = 1.0 / (alpha - beta);
    }
    for (int r = i + 1 + tid; r < n; r += nthreads) {
      const double x = r == i + 1 ? 1.0 : col[r] * scale;
      v[r] = x;
      if (r >= i + 2) col[r] = x;
    }
    if (tid == 0) {
      d[i] = col[i];
      e[i] = beta;
      tau[i] = t;
    }
    __syncthreads();
    // the trailing matrix, rows and columns i+1..n-1: the pending update and
    // p = A v in one pass over its lower triangle, in 32 x 32 tiles (rc, cc),
    // lanes over rows; each tile writes its row sums to part[cc][r] and its
    // column sums to part[rc][c] (a diagonal tile both to part[rc][.])
    const int q0 = (i + 1) / kChunk, q1 = (n - 1) / kChunk, k = q1 - q0 + 1;
    const int ntiles = k * (k + 1) / 2;
    for (int tile = warp; tile < ntiles; tile += nwarps) {
      int rc = q0, rem = tile;
      while (rem > rc - q0) {
        rem -= rc - q0 + 1;
        ++rc;
      }
      const int cc = q0 + rem;
      const int r = rc * kChunk + lane;
      const bool rok = r > i && r < n;
      const double vpr = rok ? vp[r] : 0.0, wpr = rok ? wp[r] : 0.0, vr = rok ? v[r] : 0.0;
      const int cbeg = max(cc * kChunk, i + 1), cend = min(cc * kChunk + kChunk, n);
      double rowacc = 0.0, colmine = 0.0;
      for (int c0 = cbeg; c0 < cend; c0 += kSytrdBatch) {
        double x[kSytrdBatch];
#pragma unroll
        for (int u = 0; u < kSytrdBatch; ++u) {
          const int c = c0 + u;
          x[u] = rok && c < cend && r >= c ? a[static_cast<size_t>(c) * n + r] : 0.0;
        }
        double t[kSytrdBatch];
#pragma unroll
        for (int u = 0; u < kSytrdBatch; ++u) {
          const int c = c0 + u;
          t[u] = 0.0;
          if (rok && c < cend && r >= c) {
            const double y = x[u] - vpr * wp[c] - wpr * vp[c];
            a[static_cast<size_t>(c) * n + r] = y;
            rowacc += y * v[c];
            if (r > c) t[u] = y * vr;
          }
        }
        const int u = lane - (c0 - cc * kChunk);
        const double tot = column_sums<kSytrdBatch>(t, lane, u & (kSytrdBatch - 1));
        if (u >= 0 && u < kSytrdBatch && c0 + u < cend) colmine = tot;
      }
      if (rc == cc) {
        if (rok) part[static_cast<size_t>(rc) * n + r] = rowacc + colmine;
      } else {
        if (rok) part[static_cast<size_t>(cc) * n + r] = rowacc;
        const int j = cc * kChunk + lane;
        if (j >= cbeg && j < cend) part[static_cast<size_t>(rc) * n + j] = colmine;
      }
    }
    __syncthreads();
    // x = tau A v, w = x - tau/2 (x . v) v
    double dot = 0.0;
    for (int j = i + 1 + tid; j < n; j += nthreads) {
      double p = 0.0;
      for (int q = q0; q <= q1; ++q) p += part[static_cast<size_t>(q) * n + j];
      p *= t;
      w[j] = p;
      dot += p * v[j];
    }
    dot = block_sum(dot, red);
    const double alpha2 = -0.5 * t * dot;
    for (int j = i + 1 + tid; j < n; j += nthreads) w[j] += alpha2 * v[j];
    __syncthreads();
    double* s = vp;
    vp = v;
    v = s;
    s = wp;
    wp = w;
    w = s;
  }
  if (tid == 0) {
    const int l = n - 1;
    d[l] = a[static_cast<size_t>(l) * n + l] - vp[l] * wp[l] - wp[l] * vp[l];
    e[l] = 0.0;
    tau[l] = 0.0;
  }
}

// q: (batch, n, n) row-major. Block (x, y) forms columns 32x .. 32x+31 of
// matrix y's Q: reflector i changes rows and columns i+1.. only. Each pass
// over the tile applies reflector i and sums reflector i-1's dot products
// with the updated entries, so the tile is read and written once a
// reflector, and the reflectors are staged into two buffers in turn.
__global__ void __launch_bounds__(kOrmtrThreads)
    k3_ormtr_kernel(const double* __restrict__ work, const double* __restrict__ tau_all,
                    double* __restrict__ q_all, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* qs = reinterpret_cast<double*>(smem_raw);       // n x kOrmtrCols
  double* vbuf = qs + static_cast<size_t>(n) * kOrmtrCols;  // 2 x n
  double* red = vbuf + 2 * n;                             // kOrmtrGroups x kOrmtrCols
  double* wv = red + kOrmtrGroups * kOrmtrCols;           // kOrmtrCols
  const int b = blockIdx.y, c0 = blockIdx.x * kOrmtrCols;
  const int tid = threadIdx.x, cc = tid % kOrmtrCols, g = tid / kOrmtrCols;
  const double* a = work + static_cast<size_t>(b) * n * n;
  const double* tau = tau_all + static_cast<size_t>(b) * n;
  double* q = q_all + static_cast<size_t>(b) * n * n;
  // reflector i as a column over rows i+1..n-1: 1, then work[i n + i+2 ...]
  auto stage = [&](int i, double* vs) {
    for (int r = i + 1 + tid; r < n; r += kOrmtrThreads)
      vs[r] = r == i + 1 ? 1.0 : a[static_cast<size_t>(i) * n + r];
  };
  auto weights = [&](int i) {  // wv = tau_i (v_i . Q[:, c]) from red
    if (tid < kOrmtrCols) {
      double s = 0.0;
      for (int h = 0; h < kOrmtrGroups; ++h) s += red[h * kOrmtrCols + tid];
      wv[tid] = tau[i] * s;
    }
  };
  for (int k = tid; k < n * kOrmtrCols; k += kOrmtrThreads)
    qs[k] = k / kOrmtrCols == c0 + k % kOrmtrCols ? 1.0 : 0.0;
  int i = min(n - 2, c0 + kOrmtrCols - 2);
  if (i >= 0) {
    double* vs = vbuf;
    stage(i, vs);
    __syncthreads();
    double acc = 0.0;
    for (int r = i + 1 + g; r < n; r += kOrmtrGroups) acc += vs[r] * qs[r * kOrmtrCols + cc];
    red[g * kOrmtrCols + cc] = acc;
    __syncthreads();
    weights(i);
    for (; i >= 0; --i) {
      double* vn = vs == vbuf ? vbuf + n : vbuf;
      if (i > 0) stage(i - 1, vn);
      __syncthreads();  // wv and vn ready; the last pass has read red
      const double wc = wv[cc];
      acc = g == 0 && i > 0 ? qs[i * kOrmtrCols + cc] : 0.0;  // v_{i-1}[i] = 1
      for (int r = i + 1 + g; r < n; r += kOrmtrGroups) {
        const double y = qs[r * kOrmtrCols + cc] - vs[r] * wc;
        qs[r * kOrmtrCols + cc] = y;
        acc += vn[r] * y;
      }
      if (i == 0) break;
      red[g * kOrmtrCols + cc] = acc;
      __syncthreads();
      weights(i - 1);
      vs = vn;
    }
  }
  __syncthreads();
  for (int k = tid; k < n * kOrmtrCols; k += kOrmtrThreads) {
    const int r = k / kOrmtrCols, c = c0 + k % kOrmtrCols;
    if (c < n) q[static_cast<size_t>(r) * n + c] = qs[k];
  }
}

// LAPACK's dlartg (3.10): c, s, r with [c s; -s c] [f; g] = [r; 0], from one
// reciprocal square root (the chain's time: 25 ms against 32 with a square
// root and a division, at 588 x 392 on an H100).
__device__ __forceinline__ void lartg(double f, double g, double& c, double& s, double& r) {
  if (g == 0.0) {
    c = 1.0;
    s = 0.0;
    r = f;
  } else if (f == 0.0) {
    c = 0.0;
    s = copysign(1.0, g);
    r = fabs(g);
  } else {
    const double q = f * f + g * g, inv = rsqrt(q), h = q * inv;
    r = copysign(h, f);
    c = fabs(f) * inv;
    s = copysign(inv, f) * g;
  }
}

// LAPACK's dlaev2: eigensystem of [[a, b], [b, c]]; rt1 the larger in magnitude.
__device__ void laev2(double a, double b, double c, double& rt1, double& rt2, double& cs1,
                      double& sn1) {
  const double sm = a + c, df = a - c, adf = fabs(df), tb = b + b, ab = fabs(tb);
  double acmx = c, acmn = a;
  if (fabs(a) > fabs(c)) {
    acmx = a;
    acmn = c;
  }
  double rt;
  if (adf > ab) {
    const double q = ab / adf;
    rt = adf * sqrt(1.0 + q * q);
  } else if (adf < ab) {
    const double q = adf / ab;
    rt = ab * sqrt(1.0 + q * q);
  } else {
    rt = ab * sqrt(2.0);
  }
  int sgn1;
  if (sm < 0.0) {
    rt1 = 0.5 * (sm - rt);
    sgn1 = -1;
    rt2 = (acmx / rt1) * acmn - (b / rt1) * b;
  } else if (sm > 0.0) {
    rt1 = 0.5 * (sm + rt);
    sgn1 = 1;
    rt2 = (acmx / rt1) * acmn - (b / rt1) * b;
  } else {
    rt1 = 0.5 * rt;
    rt2 = -0.5 * rt;
    sgn1 = 1;
  }
  double cs;
  int sgn2;
  if (df >= 0.0) {
    cs = df + rt;
    sgn2 = 1;
  } else {
    cs = df - rt;
    sgn2 = -1;
  }
  if (fabs(cs) > ab) {
    const double ct = -tb / cs;
    sn1 = 1.0 / sqrt(1.0 + ct * ct);
    cs1 = ct * sn1;
  } else if (ab == 0.0) {
    cs1 = 1.0;
    sn1 = 0.0;
  } else {
    const double tn = -cs / tb;
    cs1 = 1.0 / sqrt(1.0 + tn * tn);
    sn1 = tn * cs1;
  }
  if (sgn1 == sgn2) {
    const double tn = cs1;
    cs1 = -sn1;
    sn1 = tn;
  }
}

// One round of the QL/QR chain of matrix blockIdx.x (one thread): d, e
// (batch, n) and state (batch, kStateLen) are read and written back; the
// round's record goes to cs (batch, cap, 2) and sweeps (batch, scap, 4); at
// the chain's end w (batch, n) gets the sorted values and perm (batch, n)
// the columns they came from. ops/tridiag_cuda.py::steqr_chain is this
// function line for line.
__global__ void k3_steqr_chain_kernel(double* __restrict__ d_all, double* __restrict__ e_all,
                                      int* __restrict__ state_all, double* __restrict__ cs_all,
                                      int* __restrict__ sweep_all, int* __restrict__ perm_all,
                                      double* __restrict__ w_all, int n, int cap, int scap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (threadIdx.x != 0) return;
  const int b = blockIdx.x;
  int* st = state_all + static_cast<size_t>(b) * kStateLen;
  if (st[kStatus] == kFinished) st[kStatus] = kDoneBefore;
  if (st[kStatus] != kRunning) {
    st[kSweeps] = st[kRotations] = 0;
    return;
  }
  double* d = reinterpret_cast<double*>(smem_raw);
  double* e = d + n;
  double* dg = d_all + static_cast<size_t>(b) * n;
  double* eg = e_all + static_cast<size_t>(b) * n;
  for (int j = 0; j < n; ++j) {
    d[j] = dg[j];
    e[j] = eg[j];
  }
  double* cs = cs_all + static_cast<size_t>(b) * cap * 2;
  int* sw = sweep_all + static_cast<size_t>(b) * scap * kSweepLen;
  int* perm = perm_all + static_cast<size_t>(b) * n;
  const double eps2 = kEps * kEps;
  const int nmaxit = kMaxIt * n;
  int phase = st[kPhase], l1 = st[kL1], l = st[kL], lend = st[kLend], jtot = st[kJtot];
  int status = kRunning, nsw = 0, nrot = 0;
  auto room = [&](int k) { return nrot + k <= cap && nsw < scap; };
  auto record = [&](int lo, int count, int backward) {
    int* h = sw + nsw * kSweepLen;
    h[0] = lo;
    h[1] = count;
    h[2] = backward;
    h[3] = nrot;
    ++nsw;
  };
  while (true) {
    if (phase == kNewBlock) {
      if (l1 > n - 1) {
        for (int j = 0; j < n; ++j) perm[j] = j;
        for (int i = 0; i + 1 < n; ++i) {  // dsteqr's selection sort
          int k = i;
          double p = d[i];
          for (int j = i + 1; j < n; ++j)
            if (d[j] < p) {
              k = j;
              p = d[j];
            }
          if (k != i) {
            d[k] = d[i];
            d[i] = p;
            const int t = perm[i];
            perm[i] = perm[k];
            perm[k] = t;
          }
        }
        double* w = w_all + static_cast<size_t>(b) * n;
        for (int j = 0; j < n; ++j) w[j] = d[j];
        status = kFinished;
        break;
      }
      if (l1 > 0) e[l1 - 1] = 0.0;
      int m = l1;
      while (m < n - 1) {
        const double tst = fabs(e[m]);
        if (tst == 0.0) break;
        if (tst <= sqrt(fabs(d[m])) * sqrt(fabs(d[m + 1])) * kEps) {
          e[m] = 0.0;
          break;
        }
        ++m;
      }
      l = l1;
      lend = m;
      l1 = m + 1;
      if (lend == l) continue;
      if (fabs(d[lend]) < fabs(d[l])) {
        const int t = l;
        l = lend;
        lend = t;
      }
      phase = lend > l ? kQL : kQR;
      continue;
    }
    bool ended = false;
    if (phase == kQL) {
      int m = l;
      while (m < lend) {
        const double tst = fabs(e[m]);
        if (tst * tst <= (eps2 * fabs(d[m])) * fabs(d[m + 1]) + kSafmin) break;
        ++m;
      }
      if (m < lend) e[m] = 0.0;
      double p = d[l];
      if (m == l) {
        ++l;
        ended = l > lend;
      } else if (m == l + 1) {
        if (!room(1)) break;
        double rt1, rt2, c, s;
        laev2(d[l], e[l], d[l + 1], rt1, rt2, c, s);
        record(l, 1, 1);
        cs[2 * nrot] = c;
        cs[2 * nrot + 1] = -s;
        ++nrot;
        d[l] = rt1;
        d[l + 1] = rt2;
        e[l] = 0.0;
        l += 2;
        ended = l > lend;
      } else if (jtot == nmaxit) {
        ended = true;
      } else {
        if (!room(m - l)) break;
        ++jtot;
        double g = (d[l + 1] - p) / (2.0 * e[l]);
        double r = hypot(g, 1.0);
        g = d[m] - p + (e[l] / (g + copysign(r, g)));
        double s = 1.0, c = 1.0;
        p = 0.0;
        record(l, m - l, 1);
        // rotations in the order they apply; the next column's d and e are
        // read ahead of this one's stores, d[i] carried to the next as d[i+1]
        double* rec = cs + 2 * nrot;
        double ei = e[m - 1], di = d[m - 1], di1 = d[m];
        for (int i = m - 1; i >= l; --i) {
          const double en = i > l ? e[i - 1] : 0.0, dn = i > l ? d[i - 1] : 0.0;
          const double f = s * ei, bb = c * ei;
          lartg(g, f, c, s, r);
          if (i != m - 1) e[i + 1] = r;
          g = di1 - p;
          r = (di - g) * s + 2.0 * c * bb;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - bb;
          rec[2 * (m - 1 - i)] = c;
          rec[2 * (m - 1 - i) + 1] = s;
          di1 = di;
          di = dn;
          ei = en;
        }
        nrot += m - l;
        d[l] -= p;
        e[l] = g;
      }
    } else {
      int m = l;
      while (m > lend) {
        const double tst = fabs(e[m - 1]);
        if (tst * tst <= (eps2 * fabs(d[m])) * fabs(d[m - 1]) + kSafmin) break;
        --m;
      }
      if (m > lend) e[m - 1] = 0.0;
      double p = d[l];
      if (m == l) {
        --l;
        ended = l < lend;
      } else if (m == l - 1) {
        if (!room(1)) break;
        double rt1, rt2, c, s;
        laev2(d[l - 1], e[l - 1], d[l], rt1, rt2, c, s);
        record(l - 1, 1, 0);
        cs[2 * nrot] = c;
        cs[2 * nrot + 1] = s;
        ++nrot;
        d[l - 1] = rt1;
        d[l] = rt2;
        e[l - 1] = 0.0;
        l -= 2;
        ended = l < lend;
      } else if (jtot == nmaxit) {
        ended = true;
      } else {
        if (!room(l - m)) break;
        ++jtot;
        double g = (d[l - 1] - p) / (2.0 * e[l - 1]);
        double r = hypot(g, 1.0);
        g = d[m] - p + (e[l - 1] / (g + copysign(r, g)));
        double s = 1.0, c = 1.0;
        p = 0.0;
        record(m, l - m, 0);
        double* rec = cs + 2 * nrot;
        double ei = e[m], di = d[m], di1 = d[m + 1];
        for (int i = m; i < l; ++i) {
          const double en = i + 1 < l ? e[i + 1] : 0.0, dn = i + 1 < l ? d[i + 2] : 0.0;
          const double f = s * ei, bb = c * ei;
          lartg(g, f, c, s, r);
          if (i != m) e[i - 1] = r;
          g = di - p;
          r = (di1 - g) * s + 2.0 * c * bb;
          p = s * r;
          d[i] = g + p;
          g = c * r - bb;
          rec[2 * (i - m)] = c;
          rec[2 * (i - m) + 1] = s;
          di = di1;
          di1 = dn;
          ei = en;
        }
        nrot += l - m;
        d[l] -= p;
        e[l - 1] = g;
      }
    }
    if (ended) {
      if (jtot >= nmaxit) {
        status = kFailed;
        break;
      }
      phase = kNewBlock;
    }
  }
  for (int j = 0; j < n; ++j) {
    dg[j] = d[j];
    eg[j] = e[j];
  }
  st[kPhase] = phase;
  st[kL1] = l1;
  st[kL] = l;
  st[kLend] = lend;
  st[kJtot] = jtot;
  st[kStatus] = status;
  st[kSweeps] = nsw;
  st[kRotations] = nrot;
}

// Block (x, y): rows 32x .. 32x+31 of matrix y's Q (batch, n, n) row-major,
// rotated in place by the round's sweeps; at the chain's end (status
// kFinished) written back with the columns in perm's order. A sweep walks
// its columns one way (dj = +1 forward, -1 backward), reads one column a
// rotation and carries the other in a register: with x carried and y read,
// a rotation recorded as (c, s) writes c x + s y behind it and carries
// c y - s x (dlasr "R", "V" with the sine dj s). The next sweep's rotations
// are loaded into registers while this one runs; the columns and rotations
// of kApplyGroup steps are read before their chain runs.
__global__ void __launch_bounds__(kApplyRows)
    k3_steqr_apply_kernel(double* __restrict__ q_all, const int* __restrict__ state_all,
                          const double2* __restrict__ cs_all, const int4* __restrict__ sweep_all,
                          const int* __restrict__ perm_all, int n, int cap, int scap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y, r0 = blockIdx.x * kApplyRows, lane = threadIdx.x;
  const int* st = state_all + static_cast<size_t>(b) * kStateLen;
  const int status = st[kStatus], nsw = st[kSweeps];
  const bool last = status == kFinished;
  if (!(status == kRunning || last) || (nsw == 0 && !last)) return;
  double2* rot = reinterpret_cast<double2*>(smem_raw);  // one sweep's (c, s)
  double* zs = reinterpret_cast<double*>(rot + n);       // column-major, stride kApplyLd
  double* q = q_all + static_cast<size_t>(b) * n * n;
  const int rows = min(kApplyRows, n - r0);
  for (int rr = 0; rr < kApplyRows; ++rr)
    for (int c = lane; c < n; c += kApplyRows)
      zs[c * kApplyLd + rr] = rr < rows ? q[static_cast<size_t>(r0 + rr) * n + c] : 0.0;
  const double2* csb = cs_all + static_cast<size_t>(b) * cap;
  const int4* swb = sweep_all + static_cast<size_t>(b) * scap;
  double2 pf[kApplyPrefetch];
  int4 h = nsw > 0 ? swb[0] : make_int4(0, 0, 0, 0);
  int4 hnext = nsw > 1 ? swb[1] : h;
#pragma unroll
  for (int u = 0; u < kApplyPrefetch; ++u) {
    const int j = lane + kApplyRows * u;
    if (j < h.y) pf[u] = csb[h.w + j];
  }
  double* z = zs + lane;
  for (int k = 0; k < nsw; ++k) {
    __syncwarp();  // the previous sweep has read rot
#pragma unroll
    for (int u = 0; u < kApplyPrefetch; ++u) {
      const int j = lane + kApplyRows * u;
      if (j < h.y) rot[j] = pf[u];
    }
    __syncwarp();
    const int lo = h.x, count = h.y, dj = h.z ? -1 : 1;
    if (k + 1 < nsw) {  // the next sweep's rotations, and the header after it
#pragma unroll
      for (int u = 0; u < kApplyPrefetch; ++u) {
        const int j = lane + kApplyRows * u;
        if (j < hnext.y) pf[u] = csb[hnext.w + j];
      }
      h = hnext;
      if (k + 2 < nsw) hnext = swb[k + 2];
    }
    const int base = dj < 0 ? lo + count - 1 : lo + 1;
    double x = z[(base - dj) * kApplyLd];
    int j = 0;
    for (; j + kApplyGroup <= count; j += kApplyGroup) {
      double y[kApplyGroup];
      double2 cs[kApplyGroup];
#pragma unroll
      for (int u = 0; u < kApplyGroup; ++u) {
        y[u] = z[(base + dj * (j + u)) * kApplyLd];
        cs[u] = rot[j + u];
      }
#pragma unroll
      for (int u = 0; u < kApplyGroup; ++u) {  // one multiply-add on the carried chain
        const double cy = cs[u].x * y[u], sy = cs[u].y * y[u];
        z[(base + dj * (j + u - 1)) * kApplyLd] = fma(cs[u].x, x, sy);
        x = fma(-cs[u].y, x, cy);
      }
    }
    for (; j < count; ++j) {
      const double y = z[(base + dj * j) * kApplyLd];
      const double2 cs = rot[j];
      const double cy = cs.x * y, sy = cs.y * y;
      z[(base + dj * (j - 1)) * kApplyLd] = fma(cs.x, x, sy);
      x = fma(-cs.y, x, cy);
    }
    z[(base + dj * (count - 1)) * kApplyLd] = x;
  }
  __syncwarp();
  const int* perm = perm_all + static_cast<size_t>(b) * n;
  for (int rr = 0; rr < rows; ++rr)
    for (int c = lane; c < n; c += kApplyRows)
      q[static_cast<size_t>(r0 + rr) * n + c] = zs[(last ? perm[c] : c) * kApplyLd + rr];
}

int sytrd_smem(int n) { return (4 * n + 32) * static_cast<int>(sizeof(double)); }
int ormtr_smem(int n) {
  return (n * kOrmtrCols + 2 * n + (kOrmtrGroups + 1) * kOrmtrCols) *
         static_cast<int>(sizeof(double));
}
int apply_smem(int n) { return (n * kApplyLd + 2 * n) * static_cast<int>(sizeof(double)); }

bool fits(int n) {
  return n >= 1 && n - 1 <= kApplyRows * kApplyPrefetch && sytrd_smem(n) <= kMaxSmem &&
         ormtr_smem(n) <= kMaxSmem && apply_smem(n) <= kMaxSmem;
}

}  // namespace

extern "C" {

// Lets ormtr and apply take up to kMaxSmem bytes of dynamic shared memory on
// the current device; the wrapper calls it once per device. Returns a
// cudaError_t.
int k3_allow_smem() {
  // and prefer the largest shared-memory carveout: two blocks an SM at D = 392
  const void* kernels[] = {reinterpret_cast<const void*>(k3_ormtr_kernel),
                           reinterpret_cast<const void*>(k3_steqr_apply_kernel)};
  for (const void* k : kernels) {
    cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The four stages on `stream`, each over the whole batch. Shapes as the
// kernels above say; none synchronizes; each returns cudaGetLastError().
int k3_sytrd_f64(void* work, void* d, void* e, void* tau, void* part, int batch, int n,
                 void* stream) {
  if (batch < 0 || !fits(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  k3_sytrd_kernel<<<batch, kSytrdThreads, sytrd_smem(n), static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(work), static_cast<double*>(d), static_cast<double*>(e),
      static_cast<double*>(tau), static_cast<double*>(part), n);
  return static_cast<int>(cudaGetLastError());
}

int k3_ormtr_f64(const void* work, const void* tau, void* q, int batch, int n, void* stream) {
  if (batch < 0 || !fits(n)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t nn = static_cast<size_t>(n) * n;
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {  // a grid's y takes 65,535 matrices
    const dim3 grid((n + kOrmtrCols - 1) / kOrmtrCols, min(kMaxGridY, batch - b0));
    k3_ormtr_kernel<<<grid, kOrmtrThreads, ormtr_smem(n), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(work) + b0 * nn,
        static_cast<const double*>(tau) + static_cast<size_t>(b0) * n,
        static_cast<double*>(q) + b0 * nn, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

int k3_steqr_chain_f64(void* d, void* e, void* state, void* cs, void* sweeps, void* perm, void* w,
                       int batch, int n, int cap, int scap, void* stream) {
  if (batch < 0 || !fits(n) || cap < n || scap < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  k3_steqr_chain_kernel<<<batch, 1, 2 * n * static_cast<int>(sizeof(double)),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(d), static_cast<double*>(e), static_cast<int*>(state),
      static_cast<double*>(cs), static_cast<int*>(sweeps), static_cast<int*>(perm),
      static_cast<double*>(w), n, cap, scap);
  return static_cast<int>(cudaGetLastError());
}

int k3_steqr_apply_f64(void* q, const void* state, const void* cs, const void* sweeps,
                       const void* perm, int batch, int n, int cap, int scap, void* stream) {
  if (batch < 0 || !fits(n) || cap < n || scap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t nn = static_cast<size_t>(n) * n;
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const dim3 grid((n + kApplyRows - 1) / kApplyRows, min(kMaxGridY, batch - b0));
    k3_steqr_apply_kernel<<<grid, kApplyRows, apply_smem(n), static_cast<cudaStream_t>(stream)>>>(
        static_cast<double*>(q) + b0 * nn,
        static_cast<const int*>(state) + static_cast<size_t>(b0) * kStateLen,
        static_cast<const double2*>(cs) + static_cast<size_t>(b0) * cap,
        static_cast<const int4*>(sweeps) + static_cast<size_t>(b0) * scap,
        static_cast<const int*>(perm) + static_cast<size_t>(b0) * n, n, cap, scap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
