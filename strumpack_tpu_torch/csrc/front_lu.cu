// K3: cross-shape partial LU of identity-padded fronts, one CTA per front.
//
// Replaces the TPU kernel strumpack_tpu/ops/pallas_lu.py
// (pallas_partial_factor -> _lu_cross_kernel).  Eliminating the s leading
// columns of a [p, p] front touches, at step k, only the column block
// A = [F11; F21] ([p, s]) and the row block B = F12 ([s, u]); the F22
// update accumulates to exactly -L21 U12, which the caller applies as one
// batched GEMM (as the JAX package does outside its Pallas kernel).
//
// The TPU kernel rode fronts on the 128 vector lanes and did every row
// select and swap as a masked reduction, because Mosaic has no dynamic
// vector indexing.  On Hopper the model is the reference's in-shared-memory
// batched LU (FrontCUDA.cu:234-309 LU_block_kernel): one block per front,
// A and B resident in dynamic shared memory for the whole elimination,
// loaded from F once and written to the outputs once.
//
// Per column k < s:
//   * pivot: max |A[i, k]| over rows i in [k, s) only (never a CB row),
//     lowest index among ties -- warp 0 reduces (row k itself when
//     pivoting is off);
//   * physical swap of rows k and r in A, B and the permutation;
//   * tiny-pivot replacement during the elimination: |piv| < thresh ->
//     thresh (piv == 0) or copysign(thresh, piv);
//   * multipliers A[i, k] /= piv for i > k (all p rows);
//   * rank-1 update of A[i > k, j > k] and B[k < i < s, :].
// The update is a separately rounded multiply and subtract (__fmul_rn /
// __fsub_rn, no FMA contraction): it repeats the rounding of the plain
// PyTorch version, so the two agree bit for bit and no near-tie pivot
// flips between them.
//
// Bound: bytes at the shapes of the exact path ((p*s + s*u) elements in and
// out per front, ~2 s flops per element), but the s dependent steps with
// three block barriers each are what a single front waits on; the design
// keeps many small fronts resident per SM (shared memory is (p*s + s*u)
// elements) so that the steps of different fronts overlap.
#include <cuda_runtime.h>
#include <cstdint>

#include "lu_common.cuh"

namespace {

using lu::div_rn;
using lu::mul_rn;
using lu::sub_rn;

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
lu_cross_kernel(const T* __restrict__ F, T* __restrict__ lu,
                T* __restrict__ L21, T* __restrict__ U12,
                int64_t* __restrict__ perm, int p, int s, T thresh,
                int pivot) {
  extern __shared__ unsigned char smem_raw[];
  const int u = p - s;
  T* A = reinterpret_cast<T*>(smem_raw);           // [p][s]
  T* B = A + (int64_t)p * s;                        // [s][u]
  int* P = reinterpret_cast<int*>(B + (int64_t)s * u);  // [s]
  __shared__ int s_piv;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t f = blockIdx.x;
  const T* Ff = F + f * p * p;

  for (int e = tid; e < p * s; e += nt) {
    const int i = e / s, j = e - i * s;
    A[e] = Ff[(int64_t)i * p + j];
  }
  for (int e = tid; e < s * u; e += nt) {
    const int i = e / u, j = e - i * u;
    B[e] = Ff[(int64_t)i * p + s + j];
  }
  for (int i = tid; i < s; i += nt) P[i] = i;
  __syncthreads();

  for (int k = 0; k < s; ++k) {
    if (!pivot) {
      if (tid == 0) s_piv = k;
    } else if (tid < 32) {
      T best = T(-1);
      int bi = s;
      for (int i = k + tid; i < s; i += 32) {
        const T v = fabs(A[i * s + k]);
        if (v > best) { best = v; bi = i; }  // i ascends: keeps the lowest
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
      }
      if (tid == 0) s_piv = bi;
    }
    __syncthreads();
    const int r = s_piv;
    if (r != k && r < s) {
      for (int j = tid; j < s; j += nt) {
        const T t = A[k * s + j]; A[k * s + j] = A[r * s + j]; A[r * s + j] = t;
      }
      for (int j = tid; j < u; j += nt) {
        const T t = B[k * u + j]; B[k * u + j] = B[r * u + j]; B[r * u + j] = t;
      }
      if (tid == 0) { const int t = P[k]; P[k] = P[r]; P[r] = t; }
      __syncthreads();
    }
    const T piv = lu::replace_tiny(A[k * s + k], thresh);
    __syncthreads();  // every thread has read A[k, k] before it is rewritten
    if (tid == 0) A[k * s + k] = piv;
    for (int i = k + 1 + tid; i < p; i += nt) A[i * s + k] = div_rn(A[i * s + k], piv);
    __syncthreads();
    const int nc = s - k - 1;
    if (nc > 0) {
      const int na = (p - k - 1) * nc;
      for (int e = tid; e < na; e += nt) {
        const int i = k + 1 + e / nc, j = k + 1 + e % nc;
        A[i * s + j] = sub_rn(A[i * s + j], mul_rn(A[i * s + k], A[k * s + j]));
      }
      const int nb = nc * u;
      for (int e = tid; e < nb; e += nt) {
        const int i = k + 1 + e / u, j = e % u;
        B[i * u + j] = sub_rn(B[i * u + j], mul_rn(A[i * s + k], B[k * u + j]));
      }
    }
    __syncthreads();
  }

  T* luf = lu + f * s * s;
  for (int e = tid; e < s * s; e += nt) luf[e] = A[e];
  T* Lf = L21 + f * u * s;
  for (int e = tid; e < u * s; e += nt) Lf[e] = A[s * s + e];
  T* Uf = U12 + f * s * u;
  for (int e = tid; e < s * u; e += nt) Uf[e] = B[e];
  for (int i = tid; i < s; i += nt) perm[f * s + i] = P[i];
}

template <typename T>
size_t smem_bytes(int p, int s) {
  return sizeof(T) * ((size_t)p * s + (size_t)s * (p - s)) + sizeof(int) * s;
}

template <typename T>
int launch(const void* F, void* lu, void* L21, void* U12, void* perm,
           int64_t nf, int p, int s, double thresh, int pivot,
           void* stream) {
  if (nf == 0 || s == 0) return 0;
  const size_t smem = smem_bytes<T>(p, s);
  cudaError_t err = cudaFuncSetAttribute(
      lu_cross_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lu_cross_kernel<T><<<(unsigned)nf, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)F, (T*)lu, (T*)L21, (T*)U12, (int64_t*)perm, p, s,
      (T)thresh, pivot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lu_cross_f32(const void* F, void* lu, void* L21, void* U12, void* perm,
                 int64_t nf, int p, int s, double thresh, int pivot,
                 void* stream) {
  return launch<float>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot,
                       stream);
}

int lu_cross_f64(const void* F, void* lu, void* L21, void* U12, void* perm,
                 int64_t nf, int p, int s, double thresh, int pivot,
                 void* stream) {
  return launch<double>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot,
                        stream);
}

const char* front_lu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
