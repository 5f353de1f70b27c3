// K4: LU of one full-height panel per front, one CTA per front.
//
// Replaces the TPU kernel strumpack_tpu/ops/pallas_panel_lu.py
// (pallas_panel_lu -> _panel_kernel).  A panel is w <= 128 columns of a
// [p, p] front at full height, its diagonal block at rows row0..row0+w;
// the blocked LU (ops/panel_lu.py blocked_factor_bucket) applies the
// row permutation, the unit-lower triangular solve and the Schur GEMM
// between panels with library calls.  On this path it carries the LU of
// the BLR diagonal tiles of 96..256 rows (batched_lu), at most 16 tiles
// per call.
//
// The TPU kernel kept the whole column loop on-core to escape a fixed
// cost per XLA loop iteration, and pivoted LOGICALLY (rows marked, never
// moved) because a swap costs masked full-width passes there.  Here the
// loop is the CTA's; the logical pivoting is kept so the output is the
// TPU kernel's exactly: the packed panel in ORIGINAL row order plus pr[k],
// the pivot row of column k.  Rows < row0 (finished U rows) and rows
// already pivoted are frozen; the others take their multiplier.
//
// Two variants of one kernel, chosen by shape in the wrapper:
//   * shared: the panel [p][w+1] (padded rows) sits in shared memory when
//     it fits the 227 KB a block may use -- every f32 tile of the BLR path
//     (p <= 256: <= 132 KB);
//   * global: the block copies its panel to the output and eliminates
//     there (f64 at p = 256, and up to p = 8192, the dist2d shapes); only
//     the multipliers, the pivot row and the row flags are in shared
//     memory.
// Per column k < w:
//   * pivot: max |G[i, k]| over rows i in [row0, slim) not yet pivoted,
//     lowest index among ties -- every warp reduces its rows, warp 0 the
//     warps (row row0 + k when pivoting is off);
//   * tiny-pivot replacement as in K2 and K3;
//   * M[i] = G[i, k] / piv for the updatable rows (>= row0, free, != r);
//   * G[i, j] -= M[i] * G[r, j] for j in (k, w) on those rows; column k set
//     to piv (row r), M (updatable rows) or kept.
// Separately rounded multiply and subtract (__fmul_rn / __fsub_rn), as in
// the plain PyTorch version: the two agree bit for bit.
//
// Bound: bytes on the roofline (~p w^2 flops against 2 p w elements
// moved: 16 flops a byte at p = 256, w = 128 in f32, just under the
// card's 20), but the w dependent steps with four barriers each are what
// one panel waits on, and the path's calls hold 1-64 fronts, so most SMs
// idle: several panels per front in flight, or the steps of one panel
// spread over a cluster, is the way to more speed.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 128;

// larger |value| wins, NaN counts as the largest, the lower row wins a tie
template <typename T>
__device__ __forceinline__ bool beats(T v, int i, T best, int bi) {
  if (isnan(best)) return isnan(v) && i < bi;
  if (isnan(v)) return true;
  return v > best || (v == best && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
panel_lu_kernel(const T* __restrict__ in, T* __restrict__ out,
                int64_t* __restrict__ pr, int p, int w, int row0, int slim,
                T thresh, int pivot, int shared) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ T red_v[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ int s_piv;
  __shared__ T s_val;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t f = blockIdx.x;
  const T* src = in + f * p * w;
  T* of = out + f * p * w;

  T* M = reinterpret_cast<T*>(smem_raw);                 // [p]
  T* U = M + p;                                          // [w]
  unsigned char* freef = reinterpret_cast<unsigned char*>(U + w);  // [p]
  T* G;
  int ld;
  if (shared) {
    // the panel after the flags, aligned for T
    const size_t off = ((size_t)p * sizeof(T) + (size_t)w * sizeof(T) + p
                        + sizeof(T) - 1) / sizeof(T) * sizeof(T);
    G = reinterpret_cast<T*>(smem_raw + off);
    ld = w + 1;
  } else {
    G = of;
    ld = w;
  }
  for (int e = tid; e < p * w; e += THREADS) {
    const int i = e / w, j = e - i * w;
    G[i * ld + j] = src[e];
  }
  for (int i = tid; i < p; i += THREADS) freef[i] = 1;
  __syncthreads();

  for (int k = 0; k < w; ++k) {
    if (pivot) {
      T best = T(-1);
      int bi = slim;
      for (int i = row0 + tid; i < slim; i += THREADS) {
        if (!freef[i]) continue;
        const T v = fabs(G[i * ld + k]);
        if (beats(v, i, best, bi)) { best = v; bi = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (oi < slim && beats(ov, oi, best, bi)) { best = ov; bi = oi; }
      }
      if (lane == 0) { red_v[warp] = best; red_i[warp] = bi; }
      __syncthreads();
      if (warp == 0) {
        best = lane < WARPS ? red_v[lane] : T(-1);
        bi = lane < WARPS ? red_i[lane] : slim;
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (oi < slim && beats(ov, oi, best, bi)) { best = ov; bi = oi; }
        }
        if (lane == 0) s_piv = bi;
      }
    } else if (tid == 0) {
      s_piv = row0 + k;
    }
    __syncthreads();
    if (tid == 0) {
      const int r = s_piv;
      T piv = G[r * ld + k];
      if (fabs(piv) < thresh) piv = piv == T(0) ? thresh : copysign(thresh, piv);
      s_val = piv;
      pr[f * w + k] = r;
    }
    __syncthreads();
    const int r = s_piv;
    const T piv = s_val;
    for (int i = tid; i < p; i += THREADS)
      M[i] = (i >= row0 && freef[i] && i != r) ? div_rn(G[i * ld + k], piv)
                                               : T(0);
    for (int j = k + 1 + tid; j < w; j += THREADS) U[j] = G[r * ld + j];
    __syncthreads();
    const int nc = w - k - 1;
    if (nc > 0) {
      for (int e = row0 * nc + tid; e < p * nc; e += THREADS) {
        const int i = e / nc, j = k + 1 + (e - (e / nc) * nc);
        if (freef[i] && i != r)
          G[i * ld + j] = sub_rn(G[i * ld + j], mul_rn(M[i], U[j]));
      }
    }
    for (int i = row0 + tid; i < p; i += THREADS) {
      if (i == r) G[i * ld + k] = piv;
      else if (freef[i]) G[i * ld + k] = M[i];
    }
    __syncthreads();
    if (tid == 0) freef[r] = 0;
    __syncthreads();
  }

  if (shared) {
    for (int e = tid; e < p * w; e += THREADS) {
      const int i = e / w, j = e - i * w;
      of[e] = G[i * ld + j];
    }
  }
}

template <typename T>
size_t smem_bytes(int p, int w, int shared) {
  size_t b = (size_t)p * sizeof(T) + (size_t)w * sizeof(T) + p;
  if (shared) {
    b = (b + sizeof(T) - 1) / sizeof(T) * sizeof(T);
    b += (size_t)p * (w + 1) * sizeof(T);
  }
  return b;
}

template <typename T>
int launch(const void* in, void* out, void* pr, int64_t nf, int p, int w,
           int row0, int slim, double thresh, int pivot, int shared,
           void* stream) {
  if (nf == 0) return 0;
  if (w <= 0 || w > MAX_W || row0 < 0 || row0 + w > slim || slim > p)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(p, w, shared);
  cudaError_t err = cudaFuncSetAttribute(
      panel_lu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_lu_kernel<T><<<(unsigned)nf, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, (int64_t*)pr, p, w, row0, slim, (T)thresh,
      pivot, shared);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int panel_lu_f32(const void* in, void* out, void* pr, int64_t nf, int p,
                 int w, int row0, int slim, double thresh, int pivot,
                 int shared, void* stream) {
  return launch<float>(in, out, pr, nf, p, w, row0, slim, thresh, pivot,
                       shared, stream);
}

int panel_lu_f64(const void* in, void* out, void* pr, int64_t nf, int p,
                 int w, int row0, int slim, double thresh, int pivot,
                 int shared, void* stream) {
  return launch<double>(in, out, pr, nf, p, w, row0, slim, thresh, pivot,
                        shared, stream);
}

const char* panel_lu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
