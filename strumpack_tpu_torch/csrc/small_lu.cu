// K2: small-front LU of identity-padded fronts (p <= 64), rows in registers.
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
// masked full-width passes there.  The logical pivoting is kept because it
// makes the result the TPU kernel's exactly: rows already pivoted are
// frozen, the rest (CB rows too) take their multiplier, and the
// triangularizing row gather is folded into the final write (the row
// pivoted at step k goes to output row k, a row >= s to its own index).
//
// Per column k < s:
//   * pivot: max |G[i, k]| over not-yet-pivoted rows i < s, NaN largest,
//     lowest index among ties (row k itself when pivoting is off);
//   * tiny-pivot replacement during the elimination: |piv| < thresh ->
//     thresh (piv == 0) or copysign(thresh, piv);
//   * multipliers M[i] = G[i, k] / piv for free rows i != r;
//   * rank-1 update G[i, j] -= M[i] * G[r, j] for j > k on those rows,
//     column k set to piv (row r), M (free rows) or kept (pivoted rows).
// Separately rounded multiply and subtract (lu_common.cuh), as in the
// plain PyTorch version, so the two agree bit for bit.
//
// Bound: bytes on the roofline (~2 s p^2 flops per front against 2 p^2
// elements moved: 1 flop a byte at (2048, 52, 4), 5 for a 64 x 64 tile in
// f32), but in practice the s dependent steps are what a front waits on.
// Design: one thread per row of the front, its p values in registers (a
// width bucket WB of 32 or 64 whose every index is a compile-time
// constant; 64 doubles are 128 registers).  A front of p <= 32 is one warp
// and needs no block barrier: the pivot comes from the warp's integer
// reductions (lu_common.cuh), the pivot row goes through shared memory
// behind __syncwarp.  A front of 32 < p <= 64
// is two warps, joined by a named barrier of 64 threads (bar.sync id, 64)
// so that the fronts sharing a CTA never wait for each other: up to 8
// fronts (p <= 32) or 4 (p <= 64) per CTA.  A CTA's fronts share its SM's
// issue slots, so the wrapper packs only as many as it takes to fill the
// card (one front a CTA for the 16-tile calls of the BLR path, 4 for the
// 2048-front buckets).  A step costs one or two front barriers (one
// without pivoting; the pivot row is double-buffered), and its update has
// no branch: a frozen row subtracts 0 * (pivot row), as the plain version
// computes it.  Rows and the output move through a shared-memory tile in
// whole lines.
#include <cuda_runtime.h>
#include <cstdint>

#include "lu_common.cuh"

namespace {

using lu::div_rn;
using lu::mul_rn;
using lu::sub_rn;

constexpr int THREADS = 256;
constexpr int MAX_P = 64;

// the NW warps of one front: bar.sync on the front's own barrier id
template <int NW>
__device__ __forceinline__ void front_sync(int id) {
  if constexpr (NW == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(NW * 32) : "memory");
  }
}

template <typename T, int WB>
__global__ void __launch_bounds__(THREADS, 1)
small_lu_kernel(const T* __restrict__ F, T* __restrict__ out,
                int64_t* __restrict__ perm, int64_t nf, int p, int s,
                T thresh, int pivot) {
  using K = lu::pivot_key_t<T>;
  constexpr int NW = WB / 32;               // warps per front
  constexpr int NT = 32 * NW;               // threads per front
  constexpr int FPC = THREADS / NT;         // fronts per CTA, at most
  constexpr int CH = 128 / sizeof(T);       // staging chunk: 128-byte rows
  __shared__ __align__(16) T U[FPC][2][WB];  // pivot row, by step parity
  __shared__ T stage[FPC][WB * (CH + 1)];
  __shared__ K sk[FPC][NW];                 // per-warp best (NW = 2)
  __shared__ int si[FPC][NW];
  const int grp = threadIdx.x / NT;         // the front within the CTA
  const int i = threadIdx.x % NT;           // this thread's row
  const int lane = threadIdx.x & 31, wf = i >> 5;
  const int64_t f = (int64_t)blockIdx.x * (blockDim.x / NT) + grp;
  if (f >= nf) return;                      // the whole front group leaves
  const int bar_id = 1 + grp;               // 0 is __syncthreads'
  auto sync = [bar_id] { front_sync<NW>(bar_id); };

  T v[WB];
  lu::load_rows<T, 1, CH>(v, F + f * p * p, p, p, p, stage[grp], i, NT,
                           sync);
  bool fr = i < p;                          // a row, not yet pivoted
  int dest = i;                             // output row

  lu::static_for<0, WB / 32>([&](auto kbi) {
    constexpr int kb = decltype(kbi)::value;
    constexpr int J0 = kb * 32, J1 = J0 + 32;
    const int kend = min(J1, s);
#pragma unroll 1
    for (int k = J0; k < kend; ++k) {
      const int buf = k & 1;
      T x = T(0);
#pragma unroll
      for (int j = J0; j < J1; ++j) x = j == k ? v[j] : x;

      int r = k;
      if (pivot) {
        K key = fr && i < s ? lu::pivot_key(x) : K(0);
        int bi = lu::NO_ROW;
        if (key) bi = i;
        lu::warp_best(key, bi);
        if constexpr (NW > 1) {
          if (lane == 0) { sk[grp][wf] = key; si[grp][wf] = bi; }
          sync();
#pragma unroll
          for (int q = 0; q < NW; ++q) {
            const K kq = sk[grp][q];
            const int iq = si[grp][q];
            if (kq > key || (kq == key && iq < bi)) { key = kq; bi = iq; }
          }
        }
        r = bi;
      }
      const bool is_piv = i == r;
      if (is_piv) {
        T* row = U[grp][buf];
#pragma unroll
        for (int j = 0; j < WB; ++j) row[j] = v[j];
        perm[f * s + k] = r;
      }
      sync();

      // Branch-free, as the plain version computes it: every row subtracts
      // mu * (pivot row) from its columns > k, mu = 0 on frozen rows and
      // on the pivot row; column k becomes piv, the multiplier, or stays.
      const T* u = U[grp][buf];
      const T piv = lu::replace_tiny(u[k], thresh);
      const bool upd = fr && !is_piv;
      const T m = div_rn(x, piv);
      const T mu = upd ? m : T(0);
      const T colk = is_piv ? piv : m;
      const bool setk = upd || is_piv;
#pragma unroll
      for (int j = J0; j < J1; ++j) {
        const T nv = sub_rn(v[j], mul_rn(mu, u[j]));
        v[j] = j > k ? nv : (j == k && setk ? colk : v[j]);
      }
#pragma unroll
      for (int j = J1; j < WB; ++j) v[j] = sub_rn(v[j], mul_rn(mu, u[j]));
      if (is_piv) { fr = false; dest = k; }
    }
  });

  // the row pivoted at step k goes to row k, a row >= s stays
  lu::store_rows<T, 1, CH>(v, out + f * p * p, p, p, p, dest, stage[grp],
                            i, NT, sync);
}

template <typename T, int WB>
int launch_wb(const void* F, void* out, void* perm, int64_t nf, int p, int s,
              double thresh, int pivot, int fpc, cudaStream_t stream) {
  small_lu_kernel<T, WB><<<(unsigned)((nf + fpc - 1) / fpc), fpc * WB, 0,
                           stream>>>((const T*)F, (T*)out, (int64_t*)perm,
                                     nf, p, s, (T)thresh, pivot);
  return (int)cudaGetLastError();
}

// wb, fpc: the width bucket (32 or 64, >= p) and the fronts per CTA
// (1 .. 256 / wb) the wrapper chose
template <typename T>
int launch(const void* F, void* out, void* perm, int64_t nf, int p, int s,
           double thresh, int pivot, int wb, int fpc, void* stream) {
  if (nf == 0) return 0;
  if (p <= 0 || p > wb || s <= 0 || s > p || (wb != 32 && wb != MAX_P)
      || fpc < 1 || fpc * wb > THREADS)
    return (int)cudaErrorInvalidValue;
  if (wb == 32)
    return launch_wb<T, 32>(F, out, perm, nf, p, s, thresh, pivot, fpc,
                            (cudaStream_t)stream);
  return launch_wb<T, 64>(F, out, perm, nf, p, s, thresh, pivot, fpc,
                          (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int small_lu_f32(const void* F, void* out, void* perm, int64_t nf, int p,
                 int s, double thresh, int pivot, int wb, int fpc,
                 void* stream) {
  return launch<float>(F, out, perm, nf, p, s, thresh, pivot, wb, fpc,
                       stream);
}

int small_lu_f64(const void* F, void* out, void* perm, int64_t nf, int p,
                 int s, double thresh, int pivot, int wb, int fpc,
                 void* stream) {
  return launch<double>(F, out, perm, nf, p, s, thresh, pivot, wb, fpc,
                        stream);
}

const char* small_lu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
