// K2: small-front LU of identity-padded fronts (p <= 64), one CTA per front.
//
// Replaces the TPU kernel strumpack_tpu/ops/pallas_lu.py
// (pallas_factor_bucket -> _lu_kernel).  Eliminates the s leading columns
// of a whole [p, p] front, contribution block included, in one pass: the
// output is the packed front (L\U of P F11, U12, L21 and the Schur
// complement CB) plus the pivot row of each column.  It serves the dense
// buckets with p <= 64 that the cross-shape kernel K3 does not take
// (s < 8 or s == p) and, through batched_lu, the LU of BLR diagonal tiles
// up to 64 x 64 (s == p).
//
// The TPU kernel rode 128 fronts on the vector lanes and pivoted
// LOGICALLY (pivot rows marked, never moved) because a row swap costs
// masked full-width passes there.  Here the model is the reference's
// in-shared-memory batched LU (FrontCUDA.cu:234-309 LU_block_kernel): one
// block per front, the whole front resident in shared memory (<= 16.6 KB
// in f32, 33 KB in f64, padded rows), loaded from F once.  The logical
// pivoting is kept because it makes the result the TPU kernel's exactly:
// rows already pivoted are frozen, the rest (CB rows too) take their
// multiplier, and the triangularizing row gather is folded into the final
// write (out row i = front row P[i] for i < s, row i otherwise).
//
// Per column k < s:
//   * pivot: max |G[i, k]| over not-yet-pivoted rows i < s, lowest index
//     among ties -- warp 0 reduces (row k itself when pivoting is off);
//   * tiny-pivot replacement during the elimination: |piv| < thresh ->
//     thresh (piv == 0) or copysign(thresh, piv);
//   * multipliers M[i] = G[i, k] / piv for free rows i != r, 0 otherwise;
//   * rank-1 update G[i, j] -= M[i] * G[r, j] for j > k on those rows,
//     column k set to piv (row r), M (free rows) or kept (pivoted rows).
// The update is a separately rounded multiply and subtract (__fmul_rn /
// __fsub_rn, no FMA contraction), as in the plain PyTorch version, so the
// two agree bit for bit and no near-tie pivot flips between them.
//
// Bound: bytes on the roofline (~2 s p^2 flops per front against 2 p^2
// elements moved: 1 flop a byte at (2048, 52, 4), 5 for a 64 x 64 tile in
// f32, under the card's 20), but in practice the s dependent steps, four
// block barriers each, are what a front waits on.  Small fronts keep many
// CTAs resident per SM (shared memory <= 34 KB, 128 threads), so the
// steps of different fronts overlap.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

constexpr int THREADS = 128;
constexpr int MAX_P = 64;

// (v, i) beats (best, bi): larger |value| wins, NaN counts as the largest
// (torch.argmax's order), the lower row index wins a tie.
template <typename T>
__device__ __forceinline__ bool beats(T v, int i, T best, int bi) {
  if (isnan(best)) return isnan(v) && i < bi;
  if (isnan(v)) return true;
  return v > best || (v == best && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
small_lu_kernel(const T* __restrict__ F, T* __restrict__ out,
                int64_t* __restrict__ perm, int p, int s, T thresh,
                int pivot) {
  extern __shared__ unsigned char smem_raw[];
  const int ld = p + 1;                        // padded rows: column reads
  T* G = reinterpret_cast<T*>(smem_raw);       // [p][ld]  spread over banks
  T* M = G + p * ld;                           // [p] multipliers
  T* U = M + p;                                // [p] pivot row
  int* P = reinterpret_cast<int*>(U + p);      // [s] pivot row per column
  unsigned char* freef = reinterpret_cast<unsigned char*>(P + s);  // [p]
  __shared__ int s_piv;
  __shared__ T s_val;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t f = blockIdx.x;
  const T* Ff = F + f * p * p;

  for (int e = tid; e < p * p; e += nt) {
    const int i = e / p, j = e - i * p;
    G[i * ld + j] = Ff[e];
  }
  for (int i = tid; i < p; i += nt) freef[i] = 1;
  __syncthreads();

  for (int k = 0; k < s; ++k) {
    if (tid < 32) {
      int bi = k;
      if (pivot) {
        T best = T(-1);
        bi = s;
        for (int i = tid; i < s; i += 32) {
          if (!freef[i]) continue;
          const T v = fabs(G[i * ld + k]);
          if (beats(v, i, best, bi)) { best = v; bi = i; }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (oi < s && beats(ov, oi, best, bi)) { best = ov; bi = oi; }
        }
      }
      if (tid == 0) {
        T piv = G[bi * ld + k];
        if (fabs(piv) < thresh) piv = piv == T(0) ? thresh : copysign(thresh, piv);
        s_piv = bi;
        s_val = piv;
        P[k] = bi;
      }
    }
    __syncthreads();
    const int r = s_piv;
    const T piv = s_val;
    for (int i = tid; i < p; i += nt)
      M[i] = (freef[i] && i != r) ? div_rn(G[i * ld + k], piv) : T(0);
    for (int j = k + 1 + tid; j < p; j += nt) U[j] = G[r * ld + j];
    __syncthreads();
    const int nc = p - k - 1;
    for (int e = tid; e < p * nc; e += nt) {
      const int i = e / nc, j = k + 1 + (e - (e / nc) * nc);
      if (freef[i] && i != r)
        G[i * ld + j] = sub_rn(G[i * ld + j], mul_rn(M[i], U[j]));
    }
    for (int i = tid; i < p; i += nt) {
      if (i == r) G[i * ld + k] = piv;
      else if (freef[i]) G[i * ld + k] = M[i];
    }
    __syncthreads();
    if (tid == 0) freef[r] = 0;
    __syncthreads();
  }

  T* of = out + f * p * p;
  for (int e = tid; e < p * p; e += nt) {
    const int i = e / p, j = e - i * p;
    const int src = i < s ? P[i] : i;
    of[e] = G[src * ld + j];
  }
  for (int i = tid; i < s; i += nt) perm[f * s + i] = P[i];
}

template <typename T>
size_t smem_bytes(int p, int s) {
  return sizeof(T) * ((size_t)p * (p + 1) + 2 * (size_t)p)
         + sizeof(int) * s + p;
}

template <typename T>
int launch(const void* F, void* out, void* perm, int64_t nf, int p, int s,
           double thresh, int pivot, void* stream) {
  if (nf == 0) return 0;
  if (p <= 0 || p > MAX_P || s <= 0 || s > p) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(p, s);
  cudaError_t err = cudaFuncSetAttribute(
      small_lu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  small_lu_kernel<T><<<(unsigned)nf, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)F, (T*)out, (int64_t*)perm, p, s, (T)thresh, pivot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int small_lu_f32(const void* F, void* out, void* perm, int64_t nf, int p,
                 int s, double thresh, int pivot, void* stream) {
  return launch<float>(F, out, perm, nf, p, s, thresh, pivot, stream);
}

int small_lu_f64(const void* F, void* out, void* perm, int64_t nf, int p,
                 int s, double thresh, int pivot, void* stream) {
  return launch<double>(F, out, perm, nf, p, s, thresh, pivot, stream);
}

const char* small_lu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
