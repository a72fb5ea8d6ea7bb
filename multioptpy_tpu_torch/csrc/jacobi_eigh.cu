// Batched cyclic two-sided Jacobi eigensolver for small symmetric matrices,
// written for Hopper (sm_90a).
//
// Replaces: multioptpy_tpu/ops/jacobi_pallas.py::_kernel and the
// pallas_call of _jacobi_eigh_pallas_impl (line 167), the one TPU kernel of
// the JAX package. Same function: `sweeps` sweeps of D-1 rounds, each round
// D/2 disjoint circle-method pairs with the stable small-root Givens angle
// (tau = (a_qq - a_pp) / 2 a_pq, t = -sgn(tau) / (|tau| + sqrt(1 + tau^2)),
// sgn(0) = +1, pair skipped when |a_pq| < 1e-30), rows rotated, then
// columns, V accumulated, A re-symmetrized once per sweep; outputs diag(A)
// and V. Odd-D padding, the ascending sort and trimming stay in the torch
// wrapper (ops/jacobi_cuda.py), as they sat outside pallas_call.
//
// Design: one matrix per thread block. A and V live in dynamic shared
// memory (2 D^2 sizeof(T) bytes, 83 KB for f64 at D = 72, so the launcher
// raises the 48 KB default). Per round one thread per pair computes (p, q)
// from the closed form and (c, s) into shared memory; then all D/2 row
// rotations run in parallel over (pair, column); then all column rotations
// of A and V over (row, pair). The pairs of a round are disjoint, so every
// pair reads a_pp, a_qq, a_pq untouched by the others: the angles equal the
// sequential TPU kernel's and the result differs only by rounding.
// Templated on float and double: Hopper has native FP64.
//
// What bounds it: about 6 D^3 flops per sweep per matrix on A (rows and
// columns, 6 flops per rotated entry pair) plus 3 D^3 on V; the (B, D, D)
// input read once, w (B, D) and V (B, D, D) written once. For now it is
// bound by latency: 3 (D - 1) + 1 block barriers per sweep, each round a
// few dependent shared-memory passes. It is one block per matrix, so B = 1
// uses one SM of 132.

#include <cuda_runtime.h>

namespace {

// Shared memory a Hopper block may opt into (232,448 bytes of the SM's 256 KB).
constexpr size_t kMaxSmem = 232448;

template <typename T>
size_t smem_bytes(int d) {
  const size_t half = static_cast<size_t>(d / 2);
  return 2 * static_cast<size_t>(d) * d * sizeof(T) + half * (2 * sizeof(T) + 2 * sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(1024)
jacobi_kernel(const T* __restrict__ a_in, T* __restrict__ w_out, T* __restrict__ v_out,
              int d, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* V = A + d * d;
  T* C = V + d * d;
  T* S = C + d / 2;
  int* P = reinterpret_cast<int*>(S + d / 2);
  int* Q = P + d / 2;

  const int half = d / 2;
  const int m = d - 1;
  const int dd = d * d;
  const size_t base = static_cast<size_t>(blockIdx.x) * dd;

  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    A[i] = a_in[base + i];
    V[i] = (i / d == i % d) ? T(1) : T(0);
  }
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < m; ++r) {
      // 1. angles: pair k matches seats k and d-1-k of the rotating ring
      //    (index 0 fixed), as jacobi_pallas.py:56-58
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int q = 1 + (m - 1 - k - r + 2 * m) % m;
        const int p = (k == 0) ? 0 : 1 + (k - 1 - r + m) % m;
        const T app = A[p * d + p];
        const T aqq = A[q * d + q];
        const T apq = A[p * d + q];
        const bool small = fabs(apq) < T(1e-30);
        const T tau = (aqq - app) / (small ? T(1) : T(2) * apq);
        const T sgn = tau >= T(0) ? T(1) : T(-1);
        T t = -sgn / (fabs(tau) + sqrt(T(1) + tau * tau));
        if (small) t = T(0);
        const T c = T(1) / sqrt(T(1) + t * t);
        P[k] = p;
        Q[k] = q;
        C[k] = c;
        S[k] = t * c;
      }
      __syncthreads();
      // 2. rows p, q of A for every pair: M = G A
      for (int idx = threadIdx.x; idx < half * d; idx += blockDim.x) {
        const int k = idx / d;
        const int j = idx - k * d;
        const int p = P[k], q = Q[k];
        const T c = C[k], s = S[k];
        const T rp = A[p * d + j];
        const T rq = A[q * d + j];
        A[p * d + j] = c * rp + s * rq;
        A[q * d + j] = -s * rp + c * rq;
      }
      __syncthreads();
      // 3. columns p, q of A (A' = M G^T) and of V (V' = V G^T)
      for (int idx = threadIdx.x; idx < half * d; idx += blockDim.x) {
        const int i = idx / half;
        const int k = idx - i * half;
        const int p = P[k], q = Q[k];
        const T c = C[k], s = S[k];
        const T cp = A[i * d + p];
        const T cq = A[i * d + q];
        A[i * d + p] = c * cp + s * cq;
        A[i * d + q] = -s * cp + c * cq;
        const T vp = V[i * d + p];
        const T vq = V[i * d + q];
        V[i * d + p] = c * vp + s * vq;
        V[i * d + q] = -s * vp + c * vq;
      }
      __syncthreads();
    }
    // re-symmetrize once per sweep: rows and columns round differently
    for (int idx = threadIdx.x; idx < dd; idx += blockDim.x) {
      const int i = idx / d;
      const int j = idx - i * d;
      if (i < j) {
        const T sym = T(0.5) * (A[i * d + j] + A[j * d + i]);
        A[i * d + j] = sym;
        A[j * d + i] = sym;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    w_out[static_cast<size_t>(blockIdx.x) * d + i] = A[i * d + i];
  }
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    v_out[base + i] = V[i];
  }
}

template <typename T>
int launch(const void* a, void* w, void* v, int batch, int d, int sweeps, void* stream) {
  if (batch < 0 || d < 2 || d % 2 != 0 || sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(d);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(jacobi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = (d / 2) * d;
  int threads = ((work + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  jacobi_kernel<T><<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), d, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a: (batch, d, d) row-major, d even; w: (batch, d); v: (batch, d, d).
// Launches on `stream`, does not synchronize; returns cudaGetLastError().
int jacobi_eigh_f32(const void* a, void* w, void* v, int batch, int d, int sweeps, void* stream) {
  return launch<float>(a, w, v, batch, d, sweeps, stream);
}

int jacobi_eigh_f64(const void* a, void* w, void* v, int batch, int d, int sweeps, void* stream) {
  return launch<double>(a, w, v, batch, d, sweeps, stream);
}

}  // extern "C"
