// Batched cyclic two-sided Jacobi eigensolver for small symmetric matrices,
// written for Hopper (sm_90a).
//
// Replaces: multioptpy_tpu/ops/jacobi_pallas.py::_kernel and the
// pallas_call of _jacobi_eigh_pallas_impl (line 167), the one TPU kernel of
// the JAX package. Same function: `sweeps` sweeps of D-1 rounds, each round
// D/2 disjoint circle-method pairs with the stable small-root Givens angle
// (tau = (a_qq - a_pp) / 2 a_pq, t = -sgn(tau) / (|tau| + sqrt(1 + tau^2)),
// sgn(0) = +1, pair skipped when |a_pq| < 1e-30), rows rotated, then
// columns, V accumulated, A symmetric; outputs diag(A) and V. Odd-D
// padding, the ascending sort and trimming stay in the torch wrapper
// (ops/jacobi_cuda.py), as they sat outside pallas_call. The wrapper also
// chooses the variant and the launch shape (jacobi_cuda.launch_plan),
// which the launchers below check. Templated on float and double: Hopper
// has native FP64.
//
// One fused pass over A per round. The D/2 disjoint pairs of a round cut A
// into (D/2)^2 2x2 blocks, block (k, l) = rows {p_k, q_k} x columns
// {p_l, q_l}. Its owner loads it, applies G_k from the left and G_l^T from
// the right in registers (rows first, then columns: the staged update's
// order of operations, entry by entry) and stores it. Each block has one
// owner, so rows and columns need no barrier between them. Pair (p, q) of
// round r comes from the closed form with compare-and-add wraps; nothing
// divides inside a round.
//
// What bounds it on this card. Work: about 6 D^3 flops per sweep per matrix
// (3 D^3 on one triangle of the symmetric A, 3 D^3 on V; the warp variant
// rotates the whole of A, 9 D^3); bytes: the (B, D, D) input read once, w and V
// written once. Both are far below what the card takes. The D-1 rounds of
// a sweep depend on each other, and a round is a Givens angle (divides and
// square roots) and then a shared-memory read-rotate-write of A and V: the
// kernel is bound by that chain's latency and by the number of
// shared-memory instructions it issues (on the card, taking the flops out
// of the A update or padding A against bank conflicts moved its time
// little; halving A's and V's instructions moved it most).
//
//   Block variant, one matrix per block: any even D up to the shared-memory
//   limit, and D <= 32 while the batch is too small to fill the card with
//   warps. A keeps one copy of each symmetric pair, the upper triangle (row
//   stride D + 1 where it fits: rows and columns of the triangle both free
//   of bank conflicts), so only blocks k <= l are rotated, half of the
//   full update, and A needs no re-symmetrization. V is kept transposed, so
//   V' = V G^T rotates rows p_l, q_l, two adjacent elements per access. A
//   round is
//     [A update, round r]  barrier  [angles, round r+1 || V update, round r]  barrier
//   with the angles double-buffered: threads < D/2 compute the angles,
//   groups of D/2 threads own blocks (g + jG, l) of A, and the threads of
//   the other warps rows of V; consecutive threads hold consecutive l
//   (whose columns p_l, q_l are consecutive runs) or consecutive columns.
//   Two block barriers a round (the staged design had three and passed
//   over A twice).
//
//   Warp variant, D <= 32 at a batch that fills the card: one warp per
//   matrix, 4 in a block, A and V in shared memory with a row stride of 32
//   elements; lane k < D/2 computes pair k's angle and the others receive
//   (c, s) by __shfl_sync; rounds are ordered by __syncwarp only, and an SM
//   holds 28 matrices (registers bounded to keep 7 blocks resident), so the
//   batch runs near the shared-memory bandwidth. Lanes 0-15 own blocks
//   (2i, l), lanes 16-31 blocks (2i+1, l) with their two columns in the
//   other order (and s_l negated): each shared-memory instruction of a
//   warp then touches columns {p_l} in one half and {q_l} in the other,
//   disjoint sets, so f32 accesses are free of bank conflicts. A is
//   re-symmetrized once per sweep, walking pairs (i, i + delta mod D), so
//   that a warp touches distinct rows and distinct columns.

#include <cuda_runtime.h>

namespace {

// Shared memory a Hopper block may opt into (232,448 bytes of the SM's 256 KB).
constexpr int kMaxSmem = 232448;
// Row stride of the warp variant's A and V (elements).
constexpr int kWarpLd = 32;
constexpr int kWarpMaxD = 32;
constexpr int kMaxWarpsPerBlock = 4;
// Blocks a warp-variant lane owns at D = 32: k = upper, upper + 2, ...
constexpr int kWarpItems = 8;
// Blocks a warp-variant lane loads before it stores.
constexpr int kWarpChunk = 2;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// Warp-variant blocks an SM must hold: bounds the registers a thread takes
// (at most 73 f32, 128 f64).
template <typename T> struct WarpOccupancy;
template <> struct WarpOccupancy<float> { static constexpr int kMinBlocks = 7; };
template <> struct WarpOccupancy<double> { static constexpr int kMinBlocks = 4; };

// Pair k of round r, m = D - 1: index 0 is fixed, seat i >= 1 holds
// 1 + ((i - 1 - r) mod m), pair k matches seats k and D-1-k
// (jacobi_pallas.py:56-58). Both offsets lie in (-m, m), so one add wraps.
__device__ __forceinline__ void pair_of(int k, int r, int m, int& p, int& q) {
  int x = k - 1 - r;
  x += (x < 0) ? m : 0;
  p = (k == 0) ? 0 : 1 + x;
  int y = m - 1 - k - r;
  y += (y < 0) ? m : 0;
  q = 1 + y;
}

template <typename T>
__device__ __forceinline__ void givens_of(T app, T aqq, T apq, T& c, T& s) {
  const bool small = fabs(apq) < T(1e-30);
  const T tau = (aqq - app) / (small ? T(1) : T(2) * apq);
  const T sgn = tau >= T(0) ? T(1) : T(-1);
  T t = -sgn / (fabs(tau) + sqrt(T(1) + tau * tau));
  if (small) t = T(0);
  c = T(1) / sqrt(T(1) + t * t);
  s = t * c;
}

// Givens angle of pair k at round r from A (row stride ld).
template <typename T>
__device__ __forceinline__ void givens(const T* A, int ld, int k, int r, int m, T& c, T& s) {
  int p, q;
  pair_of(k, r, m, p, q);
  givens_of(A[p * ld + p], A[q * ld + q], A[p * ld + q], c, s);
}

// Canonical cell of (i, j) in the block variant's A, which keeps one copy
// of each symmetric pair: the upper triangle, row stride lda.
__device__ __forceinline__ int upper_cell(int i, int j, int lda) {
  return i <= j ? i * lda + j : j * lda + i;
}

// The same angle from the block variant's upper-triangle A.
template <typename T>
__device__ __forceinline__ void givens_upper(const T* A, int lda, int k, int r, int m, T& c,
                                             T& s) {
  int p, q;
  pair_of(k, r, m, p, q);
  givens_of(A[p * lda + p], A[q * lda + q], A[upper_cell(p, q, lda)], c, s);
}

// Blocks i < min(n, N): rows {pk[i], qk[i]} x columns {c1, c2} of A (row
// stride ld), M = G_k X, then A' = M G_l^T. (c1, c2, sl) is (p_l, q_l, s_l)
// or, equivalently, (q_l, p_l, -s_l). Every load comes before the first
// store: the blocks are disjoint.
template <typename T, int N>
__device__ __forceinline__ void rotate_a_blocks(T* A, int ld, int n, const int* pk, const int* qk,
                                                int c1, int c2, const T* ck, const T* sk, T cl,
                                                T sl) {
  T x[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      x[i][0] = A[pk[i] * ld + c1];
      x[i][1] = A[pk[i] * ld + c2];
      x[i][2] = A[qk[i] * ld + c1];
      x[i][3] = A[qk[i] * ld + c2];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const T m11 = ck[i] * x[i][0] + sk[i] * x[i][2], m21 = -sk[i] * x[i][0] + ck[i] * x[i][2];
      const T m12 = ck[i] * x[i][1] + sk[i] * x[i][3], m22 = -sk[i] * x[i][1] + ck[i] * x[i][3];
      A[pk[i] * ld + c1] = cl * m11 + sl * m12;
      A[pk[i] * ld + c2] = -sl * m11 + cl * m12;
      A[qk[i] * ld + c1] = cl * m21 + sl * m22;
      A[qk[i] * ld + c2] = -sl * m21 + cl * m22;
    }
  }
}

// The same blocks of V: V' = V G_l^T.
template <typename T, int N>
__device__ __forceinline__ void rotate_v_blocks(T* V, int ld, int n, const int* pk, const int* qk,
                                                int c1, int c2, T cl, T sl) {
  T x[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      x[i][0] = V[pk[i] * ld + c1];
      x[i][1] = V[pk[i] * ld + c2];
      x[i][2] = V[qk[i] * ld + c1];
      x[i][3] = V[qk[i] * ld + c2];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      V[pk[i] * ld + c1] = cl * x[i][0] + sl * x[i][1];
      V[pk[i] * ld + c2] = -sl * x[i][0] + cl * x[i][1];
      V[qk[i] * ld + c1] = cl * x[i][2] + sl * x[i][3];
      V[qk[i] * ld + c2] = -sl * x[i][2] + cl * x[i][3];
    }
  }
}

// Pair {i, i + delta mod d} of the re-symmetrization, delta = 1 .. d/2
// (at delta = d/2 only i < d/2): every i < j exactly once.
template <typename T>
__device__ __forceinline__ void symmetrize_pair(T* A, int ld, int d, int i, int delta) {
  int j = i + delta;
  j -= (j >= d) ? d : 0;
  const T sym = T(0.5) * (A[i * ld + j] + A[j * ld + i]);
  A[i * ld + j] = sym;
  A[j * ld + i] = sym;
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock, WarpOccupancy<T>::kMinBlocks)
jacobi_warp_kernel(const T* __restrict__ a_in, T* __restrict__ w_out, T* __restrict__ v_out,
                   int batch, int d, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long mat = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (mat >= batch) return;  // tail warp; nothing below waits for the block
  T* A = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * d * kWarpLd;
  T* V = A + d * kWarpLd;
  const size_t base = static_cast<size_t>(mat) * d * d;

  for (int i = 0; i < d; ++i) {
    if (lane < d) {
      A[i * kWarpLd + lane] = a_in[base + i * d + lane];
      V[i * kWarpLd + lane] = (i == lane) ? T(1) : T(0);
    }
  }
  __syncwarp();

  const int half = d >> 1;
  const int m = d - 1;
  const int l = lane & 15;
  const int upper = lane >> 4;
  const int n_shfl = (half + 1) >> 1;  // blocks of a lower lane
  const int n_mine = (l < half) ? (upper ? half >> 1 : n_shfl) : 0;
  // lanes >= half compute pair 0's angle too (uniform work) and never share it
  const int k_angle = (lane < half) ? lane : 0;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    T c, s;
    givens(A, kWarpLd, k_angle, 0, m, c, s);
    __syncwarp();
    for (int r = 0; r < m; ++r) {
      int pl, ql;
      pair_of(l, r, m, pl, ql);
      const T cl = __shfl_sync(kFullMask, c, l);
      T sl = __shfl_sync(kFullMask, s, l);
      int c1 = pl, c2 = ql;
      if (upper) {
        c1 = ql;
        c2 = pl;
        sl = -sl;
      }
      int pk[kWarpItems], qk[kWarpItems];
      T ck[kWarpItems], sk[kWarpItems];
#pragma unroll
      for (int i = 0; i < kWarpItems; ++i) {
        if (i < n_shfl) {
          const int k = 2 * i + upper;
          ck[i] = __shfl_sync(kFullMask, c, k);
          sk[i] = __shfl_sync(kFullMask, s, k);
          pair_of(k, r, m, pk[i], qk[i]);
        }
      }
#pragma unroll
      for (int i0 = 0; i0 < kWarpItems; i0 += kWarpChunk) {
        rotate_a_blocks<T, kWarpChunk>(A, kWarpLd, n_mine - i0, pk + i0, qk + i0, c1, c2, ck + i0,
                                       sk + i0, cl, sl);
      }
      __syncwarp();
      if (r + 1 < m) givens(A, kWarpLd, k_angle, r + 1, m, c, s);
#pragma unroll
      for (int i0 = 0; i0 < kWarpItems; i0 += kWarpChunk) {
        rotate_v_blocks<T, kWarpChunk>(V, kWarpLd, n_mine - i0, pk + i0, qk + i0, c1, c2, cl, sl);
      }
      if (r + 1 == m) {
        // re-symmetrize once per sweep: rows and columns round differently
        for (int delta = 1; delta <= half; ++delta) {
          if (lane < d && (delta < half || lane < half)) symmetrize_pair(A, kWarpLd, d, lane, delta);
        }
      }
      __syncwarp();
    }
  }

  if (lane < d) w_out[static_cast<size_t>(mat) * d + lane] = A[lane * kWarpLd + lane];
  for (int i = 0; i < d; ++i) {
    if (lane < d) v_out[base + i * d + lane] = V[i * kWarpLd + lane];
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
jacobi_block_kernel(const T* __restrict__ a_in, T* __restrict__ w_out, T* __restrict__ v_out,
                    int d, int lda, int sweeps) {
  using T2 = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);                // upper triangle, d x lda
  T2* VT = reinterpret_cast<T2*>(A + d * lda);          // V transposed, d x d/2 pairs
  T2* CS = VT + d * (d / 2);                            // two rounds' (c, s)

  const int half = d / 2;
  const int m = d - 1;
  const int dd = d * d;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * dd;
  T* vt = reinterpret_cast<T*>(VT);

  for (int i = t; i < dd; i += nt) {
    const int row = i / d, col = i - (i / d) * d;
    if (row <= col) A[row * lda + col] = a_in[base + i];
    vt[i] = (row == col) ? T(1) : T(0);
  }
  // A update: groups of half threads, thread (g, l) owns blocks (g + j G, l)
  // with k <= l
  const int g_a = nt / half;
  const bool a_worker = t < g_a * half;
  const int l_a = t % half, k_a = t / half;
  // V update: groups of half threads of the warps without an angle thread,
  // thread (g, c) owns rows p_l, q_l of VT, columns 2c and 2c + 1, for
  // l = g + j G
  const int vt0 = 32 * ((half + 31) / 32);
  const int g_v = (nt - vt0) / half;
  const bool v_worker = t >= vt0 && t - vt0 < g_v * half;
  const int c_v = (t - vt0) % half, l_v = (t - vt0) / half;
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < m; ++r) {
      const T2* cs = CS + (r & 1) * half;
      if (r == 0 && t < half) {
        T c, s;
        givens_upper(A, lda, t, 0, m, c, s);
        CS[t] = T2{c, s};
      }
      if (r == 0) __syncthreads();
      if (a_worker) {
        int pl, ql;
        pair_of(l_a, r, m, pl, ql);
        const T2 gl = cs[l_a];
        for (int k = k_a; k <= l_a; k += g_a) {
          int pk, qk;
          pair_of(k, r, m, pk, qk);
          const T2 gk = cs[k];
          const int i11 = upper_cell(pk, pl, lda), i12 = upper_cell(pk, ql, lda);
          const int i21 = upper_cell(qk, pl, lda), i22 = upper_cell(qk, ql, lda);
          const T x11 = A[i11], x12 = A[i12], x21 = A[i21], x22 = A[i22];
          const T m11 = gk.x * x11 + gk.y * x21, m21 = -gk.y * x11 + gk.x * x21;
          const T m12 = gk.x * x12 + gk.y * x22, m22 = -gk.y * x12 + gk.x * x22;
          // on a diagonal block (k == l) cells 12 and 21 coincide; the
          // later store, (q_k, p_l), stands
          A[i11] = gl.x * m11 + gl.y * m12;
          A[i12] = -gl.y * m11 + gl.x * m12;
          A[i21] = gl.x * m21 + gl.y * m22;
          A[i22] = -gl.y * m21 + gl.x * m22;
        }
      }
      __syncthreads();
      if (r + 1 < m && t < half) {
        T c, s;
        givens_upper(A, lda, t, r + 1, m, c, s);
        CS[((r + 1) & 1) * half + t] = T2{c, s};
      }
      if (v_worker) {
        for (int l = l_v; l < half; l += g_v) {
          int pl, ql;
          pair_of(l, r, m, pl, ql);
          const T2 gl = cs[l];
          const T2 vp = VT[pl * half + c_v], vq = VT[ql * half + c_v];
          VT[pl * half + c_v] = T2{gl.x * vp.x + gl.y * vq.x, gl.x * vp.y + gl.y * vq.y};
          VT[ql * half + c_v] = T2{-gl.y * vp.x + gl.x * vq.x, -gl.y * vp.y + gl.x * vq.y};
        }
      }
      __syncthreads();
    }
  }

  for (int i = t; i < d; i += nt) {
    w_out[static_cast<size_t>(blockIdx.x) * d + i] = A[i * lda + i];
  }
  for (int i = t; i < dd; i += nt) {
    const int row = i / d, col = i - (i / d) * d;
    v_out[base + i] = vt[col * d + row];
  }
}

template <typename T>
int launch_warp(const void* a, void* w, void* v, int batch, int d, int sweeps, int grid,
                int threads, int smem, void* stream) {
  if (batch < 0 || d < 2 || d > kWarpMaxD || d % 2 != 0 || sweeps < 0 || threads % 32 != 0 ||
      threads < 32 || threads > 32 * kMaxWarpsPerBlock ||
      static_cast<long long>(grid) * (threads / 32) < batch ||
      smem != (threads / 32) * 2 * d * kWarpLd * static_cast<int>(sizeof(T)) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  jacobi_warp_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), batch, d, sweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_block(const void* a, void* w, void* v, int batch, int d, int sweeps, int grid,
                 int threads, int smem, void* stream) {
  const int half = d / 2;
  const int vt0 = 32 * ((half + 31) / 32);
  const int item = static_cast<int>(sizeof(T));
  // A's row stride: d + 1 (rows and columns of the triangle both free of
  // bank conflicts) where it fits, else d
  const int lda = (d * (d + 1) + d * d + 2 * d) * item <= kMaxSmem ? d + 1 : d;
  if (batch < 0 || grid != batch || d < 2 || d % 2 != 0 || sweeps < 0 || threads % 32 != 0 ||
      threads > 1024 || threads - vt0 < half || smem != (d * lda + d * d + 2 * d) * item ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  jacobi_block_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), d, lda, sweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
cudaError_t allow_smem() {
  const cudaError_t err = cudaFuncSetAttribute(
      jacobi_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(jacobi_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace

extern "C" {

// Lets both variants of one dtype take up to kMaxSmem bytes of dynamic
// shared memory on the current device; the wrapper calls it once per
// device and dtype. Returns a cudaError_t.
int jacobi_eigh_allow_smem(int f64) {
  return static_cast<int>(f64 ? allow_smem<double>() : allow_smem<float>());
}

// a: (batch, d, d) row-major, d even; w: (batch, d); v: (batch, d, d).
// grid, threads and smem are the wrapper's launch plan
// (ops/jacobi_cuda.py::launch_plan), checked here. Launches on `stream`,
// does not synchronize; returns cudaGetLastError().
int jacobi_eigh_warp_f32(const void* a, void* w, void* v, int batch, int d, int sweeps, int grid,
                         int threads, int smem, void* stream) {
  return launch_warp<float>(a, w, v, batch, d, sweeps, grid, threads, smem, stream);
}

int jacobi_eigh_warp_f64(const void* a, void* w, void* v, int batch, int d, int sweeps, int grid,
                         int threads, int smem, void* stream) {
  return launch_warp<double>(a, w, v, batch, d, sweeps, grid, threads, smem, stream);
}

int jacobi_eigh_block_f32(const void* a, void* w, void* v, int batch, int d, int sweeps, int grid,
                          int threads, int smem, void* stream) {
  return launch_block<float>(a, w, v, batch, d, sweeps, grid, threads, smem, stream);
}

int jacobi_eigh_block_f64(const void* a, void* w, void* v, int batch, int d, int sweeps, int grid,
                          int threads, int smem, void* stream) {
  return launch_block<double>(a, w, v, batch, d, sweeps, grid, threads, smem, stream);
}

}  // extern "C"
