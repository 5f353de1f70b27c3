// K4: LU of one full-height panel per front.
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
// moved) because a swap costs masked full-width passes there.  The output
// here is the TPU kernel's exactly: the packed panel in ORIGINAL row order
// plus pr[k], the pivot row of column k.  Rows < row0 (finished U rows) and
// rows already pivoted are frozen; the others take their multiplier.
//
// Per column k < w:
//   * pivot: max |G[i, k]| over rows i in [row0, slim) not yet pivoted,
//     NaN largest, lowest index among ties (row row0 + k when pivoting is
//     off);
//   * tiny-pivot replacement as in K2 and K3;
//   * M[i] = G[i, k] / piv for the updatable rows (>= row0, free, != r);
//   * G[i, j] -= M[i] * G[r, j] for j in (k, w) on those rows; column k set
//     to piv (row r), M (updatable rows) or kept.
// Separately rounded multiply and subtract (lu_common.cuh), as in the
// plain PyTorch version: the two agree bit for bit.
//
// Bound: on the roofline, bytes (~p w^2 flops against 2 p w elements
// moved); in practice the w dependent steps, each a pivot reduction and a
// broadcast, are what a panel waits on.  The design keeps each step short:
//
//   * "reg" (designs "cta" and "cluster" of the wrapper): every row of the
//     panel at or below row0 lives in registers, one thread per row (f32)
//     or two threads per row, columns interleaved (f64), as an array of a
//     width bucket WB in {32, 64, 96, 128} whose every index is a
//     compile-time constant (the column loop runs in blocks of 32 with the
//     block index a template constant: no local memory).  A step is the
//     warp's integer reductions for the pivot (lu_common.cuh), one
//     exchange of per-warp slots in shared memory, the owner of the pivot
//     row writing it to shared memory, and the rank-1 update of every row
//     in its own registers: two block barriers (one without pivoting), no
//     integer division.  The update has no branch: a frozen row subtracts
//     0 * (pivot row), as the plain version computes it, because a branch
//     a column cost more than the multiply-subtract on the card.  Rows and
//     the output move through a shared-memory tile in whole lines.  A
//     panel that one CTA's registers cannot hold (f64 at
//     p = 256, f32 at p = 2048: at most 256 rows f32, 128 f64 per CTA)
//     takes a thread-block cluster of c <= 16 CTAs: each CTA publishes its
//     best candidate and that candidate's row in its shared memory
//     (double-buffered by step parity), one cluster barrier, and every CTA
//     reduces the c slots and copies the winner's row through distributed
//     shared memory.
//   * "global": panels no 16-CTA cluster holds (f32 p > 4096 at w = 128,
//     the dist2d shapes) keep the earlier design: one CTA per front
//     eliminating in the output in device memory, through L2.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cstdint>

#include "lu_common.cuh"

namespace cg = cooperative_groups;

namespace {

using lu::div_rn;
using lu::mul_rn;
using lu::sub_rn;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 128;
constexpr int MAX_P = 8192;
constexpr int MAX_CLUSTER = 16;

// ---------------------------------------------------------------------------
// "reg": rows in registers, one CTA or a cluster of CTAs per front
// ---------------------------------------------------------------------------

template <typename T, int WB, bool CL>
__global__ void __launch_bounds__(THREADS, 1)
panel_lu_reg(const T* __restrict__ in, T* __restrict__ out,
             int64_t* __restrict__ pr, int p, int w, int row0, int slim,
             T thresh, int pivot, int rc) {
  using K = lu::pivot_key_t<T>;
  constexpr int S = sizeof(T) / 4;          // threads per row
  constexpr int CW = WB / S;                // columns a thread holds
  constexpr int CH = 128 / sizeof(T);       // staging chunk: 128-byte rows
  __shared__ __align__(16) T U[2][WB];      // the pivot row, by step parity
  __shared__ __align__(16) T cand[CL ? 2 : 1][CL ? WB : 1];  // CL: the CTA's best row
  __shared__ T stage[THREADS / S * (CH + 1)];
  __shared__ K wk[WARPS];                   // per-warp best
  __shared__ int wi[WARPS];
  __shared__ K ck[2];                       // CL: the CTA's best
  __shared__ int ci[2];

  int rank = 0, c = 1;
  int64_t f = blockIdx.x;
  if constexpr (CL) {
    rank = (int)cg::this_cluster().block_rank();
    c = (int)cg::this_cluster().num_blocks();
    f = blockIdx.x / c;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarp = nt >> 5;
  const int h = tid % S;                    // this thread's column phase
  const int base = row0 + rank * rc;        // the CTA's first row
  const int i = base + tid / S;             // this thread's row
  const int nrows = max(0, min(rc, p - base));
  const T* src = in + f * p * w;
  T* dst = out + f * p * w;
  auto sync = [] { __syncthreads(); };

  // rows < row0 pass through unchanged
  for (int e = rank * nt + tid; e < row0 * w; e += c * nt) dst[e] = src[e];

  T v[CW];                                  // columns h, h + S, h + 2S, ...
  lu::load_rows<T, S, CH>(v, src + (int64_t)base * w, w, nrows, w, stage,
                          tid, nt, sync);
  bool fr = i < p;                          // a row, not yet pivoted

  lu::static_for<0, WB / 32>([&](auto kbi) {
    constexpr int kb = decltype(kbi)::value;
    constexpr int J0 = kb * 32 / S, J1 = (kb + 1) * 32 / S;
    const int kend = min((kb + 1) * 32, w);
#pragma unroll 1
    for (int k = kb * 32; k < kend; ++k) {
      const int buf = k & 1;
      const int hk = k % S;                 // the phase that holds column k
      T x = T(0);
#pragma unroll
      for (int jj = J0; jj < J1; ++jj) x = jj * S + h == k ? v[jj] : x;

      int r = row0 + k;
      if (pivot) {
        K key = fr && h == hk && i < slim ? lu::pivot_key(x) : K(0);
        int bi = lu::NO_ROW;
        if (key) bi = i;
        lu::warp_best(key, bi);
        if (lane == 0) { wk[warp] = key; wi[warp] = bi; }
        __syncthreads();
        key = lane < nwarp ? wk[lane] : K(0);
        bi = lane < nwarp ? wi[lane] : lu::NO_ROW;
        lu::warp_best(key, bi);             // every warp: the CTA's best
        r = bi;
        if constexpr (CL) {
          if (tid == 0) { ck[buf] = key; ci[buf] = bi; }
        }
      }
      // the owner of row r (the CTA's candidate in a cluster) publishes it
      if (i == r) {
        T* row = CL ? &cand[CL ? buf : 0][h] : &U[buf][h];
#pragma unroll
        for (int jj = 0; jj < CW; ++jj) row[jj * S] = v[jj];
      }
      if constexpr (CL) {
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        if (pivot) {
          K key = 0;
          int bi = lu::NO_ROW;
          if (lane < c) {
            key = *cl.map_shared_rank(&ck[buf], lane);
            bi = *cl.map_shared_rank(&ci[buf], lane);
          }
          lu::warp_best(key, bi);           // the front's pivot
          r = bi;
        }
        const T* rem = cl.map_shared_rank(&cand[buf][0], (r - row0) / rc);
        for (int j = tid; j < WB; j += nt) U[buf][j] = rem[j];
      }
      __syncthreads();

      // Branch-free, as the plain version computes it: every row subtracts
      // mu * (pivot row) from its columns > k, mu = 0 on frozen rows and
      // on the pivot row; column k becomes piv, the multiplier, or stays.
      const T piv = lu::replace_tiny(U[buf][k], thresh);
      const bool is_piv = i == r;
      const bool upd = fr && !is_piv;
      T m = div_rn(x, piv);                 // meaningful in phase hk only
      if constexpr (S > 1) m = __shfl_sync(0xffffffffu, m, (lane & ~(S - 1)) | hk);
      const T mu = upd ? m : T(0);
      const T colk = is_piv ? piv : m;
      const bool setk = upd || is_piv;
      const T* u = &U[buf][h];
#pragma unroll
      for (int jj = J0; jj < J1; ++jj) {
        const int j = jj * S + h;
        const T nv = sub_rn(v[jj], mul_rn(mu, u[jj * S]));
        v[jj] = j > k ? nv : (j == k && setk ? colk : v[jj]);
      }
#pragma unroll
      for (int jj = J1; jj < CW; ++jj)
        v[jj] = sub_rn(v[jj], mul_rn(mu, u[jj * S]));
      if (is_piv) {
        if (h == hk) pr[f * w + k] = r;
        fr = false;
      }
    }
  });

  lu::store_rows<T, S, CH>(v, dst + (int64_t)base * w, w, nrows, w, tid / S,
                           stage, tid, nt, sync);
  // the other CTAs may still read this CTA's shared memory
  if constexpr (CL) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// "global": one CTA per front, the panel eliminated in the output
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
panel_lu_global(const T* __restrict__ in, T* __restrict__ out,
                int64_t* __restrict__ pr, int p, int w, int row0, int slim,
                T thresh, int pivot) {
  using K = lu::pivot_key_t<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ K red_k[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ int s_piv;
  __shared__ T s_val;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t f = blockIdx.x;
  const T* src = in + f * p * w;
  T* G = out + f * p * w;

  T* M = reinterpret_cast<T*>(smem_raw);                 // [p]
  T* U = M + p;                                          // [w]
  unsigned char* freef = reinterpret_cast<unsigned char*>(U + w);  // [p]
  for (int e = tid; e < p * w; e += THREADS) G[e] = src[e];
  for (int i = tid; i < p; i += THREADS) freef[i] = 1;
  __syncthreads();

  for (int k = 0; k < w; ++k) {
    if (pivot) {
      K best = 0;
      int bi = lu::NO_ROW;
      for (int i = row0 + tid; i < slim; i += THREADS) {
        if (!freef[i]) continue;
        const K key = lu::pivot_key(G[i * w + k]);
        if (key > best) { best = key; bi = i; }   // i ascends: lowest kept
      }
      lu::warp_best(best, bi);
      if (lane == 0) { red_k[warp] = best; red_i[warp] = bi; }
      __syncthreads();
      if (warp == 0) {
        best = lane < WARPS ? red_k[lane] : K(0);
        bi = lane < WARPS ? red_i[lane] : lu::NO_ROW;
        lu::warp_best(best, bi);
        if (lane == 0) s_piv = bi;
      }
    } else if (tid == 0) {
      s_piv = row0 + k;
    }
    __syncthreads();
    if (tid == 0) {
      const int r = s_piv;
      s_val = lu::replace_tiny(G[r * w + k], thresh);
      pr[f * w + k] = r;
    }
    __syncthreads();
    const int r = s_piv;
    const T piv = s_val;
    for (int i = tid; i < p; i += THREADS)
      M[i] = (i >= row0 && freef[i] && i != r) ? div_rn(G[i * w + k], piv)
                                               : T(0);
    for (int j = k + 1 + tid; j < w; j += THREADS) U[j] = G[r * w + j];
    __syncthreads();
    const int nc = w - k - 1;
    if (nc > 0) {
      for (int e = row0 * nc + tid; e < p * nc; e += THREADS) {
        const int i = e / nc, j = k + 1 + (e - (e / nc) * nc);
        if (freef[i] && i != r)
          G[i * w + j] = sub_rn(G[i * w + j], mul_rn(M[i], U[j]));
      }
    }
    for (int i = row0 + tid; i < p; i += THREADS) {
      if (i == r) G[i * w + k] = piv;
      else if (freef[i]) G[i * w + k] = M[i];
    }
    __syncthreads();
    if (tid == 0) freef[r] = 0;
    __syncthreads();
  }
}

template <typename T>
constexpr size_t global_smem(int p, int w) {
  return (size_t)p * sizeof(T) + (size_t)w * sizeof(T) + p;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int WB>
int launch_reg(const T* in, T* out, int64_t* pr, int64_t nf, int p, int w,
               int row0, int slim, T thresh, int pivot, int c,
               cudaStream_t stream) {
  constexpr int S = sizeof(T) / 4;
  const int n = p - row0;
  int rc = (n + c - 1) / c;
  rc = (rc + 31) / 32 * 32;                 // whole warps
  if (rc * S > THREADS || (int64_t)c * rc < n) return (int)cudaErrorInvalidValue;
  const unsigned threads = (unsigned)(rc * S);
  if (c == 1) {
    panel_lu_reg<T, WB, false><<<(unsigned)nf, threads, 0, stream>>>(
        in, out, pr, p, w, row0, slim, thresh, pivot, rc);
    return (int)cudaGetLastError();
  }
  static bool attr_set = false;             // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        panel_lu_reg<T, WB, true>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nf * c));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, panel_lu_reg<T, WB, true>, in,
                                       out, pr, p, w, row0, slim, thresh,
                                       pivot, rc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in_, void* out_, void* pr_, int64_t nf, int p, int w,
           int row0, int slim, double thresh_, int pivot, int cluster,
           void* stream_) {
  if (nf == 0) return 0;
  if (w <= 0 || w > MAX_W || row0 < 0 || row0 + w > slim || slim > p
      || p > MAX_P || cluster < 0 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const T* in = (const T*)in_;
  T* out = (T*)out_;
  int64_t* pr = (int64_t*)pr_;
  const T thresh = (T)thresh_;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (cluster == 0) {
    static bool attr_set = false;           // once per instantiation
    if (!attr_set) {
      cudaError_t err = cudaFuncSetAttribute(
          panel_lu_global<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)global_smem<T>(MAX_P, MAX_W));
      if (err != cudaSuccess) return (int)err;
      attr_set = true;
    }
    panel_lu_global<T><<<(unsigned)nf, THREADS, global_smem<T>(p, w),
                         stream>>>(in, out, pr, p, w, row0, slim, thresh,
                                   pivot);
    return (int)cudaGetLastError();
  }
  switch ((w + 31) / 32) {
    case 1: return launch_reg<T, 32>(in, out, pr, nf, p, w, row0, slim, thresh, pivot, cluster, stream);
    case 2: return launch_reg<T, 64>(in, out, pr, nf, p, w, row0, slim, thresh, pivot, cluster, stream);
    case 3: return launch_reg<T, 96>(in, out, pr, nf, p, w, row0, slim, thresh, pivot, cluster, stream);
    default: return launch_reg<T, 128>(in, out, pr, nf, p, w, row0, slim, thresh, pivot, cluster, stream);
  }
}

}  // namespace

extern "C" {

// cluster: 0 runs the "global" design, c >= 1 the register design on
// clusters of c CTAs (c = 1: one plain CTA per front)
int panel_lu_f32(const void* in, void* out, void* pr, int64_t nf, int p,
                 int w, int row0, int slim, double thresh, int pivot,
                 int cluster, void* stream) {
  return launch<float>(in, out, pr, nf, p, w, row0, slim, thresh, pivot,
                       cluster, stream);
}

int panel_lu_f64(const void* in, void* out, void* pr, int64_t nf, int p,
                 int w, int row0, int slim, double thresh, int pivot,
                 int cluster, void* stream) {
  return launch<double>(in, out, pr, nf, p, w, row0, slim, thresh, pivot,
                        cluster, stream);
}

const char* panel_lu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
