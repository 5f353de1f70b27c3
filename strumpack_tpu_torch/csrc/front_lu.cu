// K3: cross-shape partial LU of identity-padded fronts, rows in registers.
//
// Replaces the TPU kernel strumpack_tpu/ops/pallas_lu.py
// (pallas_partial_factor -> _lu_cross_kernel).  Eliminating the s leading
// columns of a [p, p] front touches only the column block A = [F11; F21]
// ([p, s]) and the row block B = F12 ([s, u]); the F22 update accumulates
// to exactly -L21 U12, which the caller applies as one batched GEMM (as the
// JAX package does outside its Pallas kernel).
//
// Per column k < s (the plain version's order, ops/front_lu.py):
//   * pivot: max |A[i, k]| over the rows at positions [k, s) only (never a
//     CB row), NaN largest, the lowest current position among ties (row k
//     itself when pivoting is off);
//   * physical swap of positions k and r (A's rows, B's rows, perm);
//   * tiny-pivot replacement during the elimination (lu_common.cuh);
//   * multipliers A[i, k] / piv and the rank-1 update of the rows at
//     positions > k, in A's columns > k and in B.
// Separately rounded multiply and subtract (lu_common.cuh), as in the plain
// version, so that the two agree bit for bit.
//
// Bound: bytes.  A and B are read once and lu, L21, U12 written once,
// 2 (p s + s u) elements, against about s (p s + s u) flops: s / 8 flops
// a byte in f32 (8 at s = 64), under the card's 20.  What a front
// waits on is the chain of s dependent steps, and what the SM spends is
// instructions; the design keeps each step to one barrier and to the
// arithmetic that must be done:
//
//   * Phase 1, A: one thread per row of [F11; F21] holds the row's s
//     values in registers, in an array of a width bucket WB (the pad sizes
//     8, 16, 24, 32, 48, 64 >= s).  The step loop is unrolled with its
//     index k a compile-time constant (lu::static_for): column k is a
//     register, and the update touches only the columns > k, so no element
//     pays a test of its column against k.  Rows never move: each thread
//     carries its row's current position, and a swap exchanges two
//     positions.  The pivot is the warp's integer reduction over the rows
//     at positions [k, s) (lu_common.cuh's key, with the POSITION as the
//     tie-break, so the lowest current position wins, as torch.argmax does
//     after the plain version's swaps); for s <= 32 these rows are warp 0
//     alone.  The pivot row's owner writes it to shared memory, one barrier
//     of the front (bar.sync on the front's own id), and every row updates
//     in its registers, reading the pivot row in 16-byte vectors; rows at
//     positions <= k are left alone, as the plain version leaves them.  s >
//     32 with pivoting adds one barrier to join the two warps' candidates.
//     The pivot row is double-buffered by step parity, so one barrier a
//     step is enough.
//   * Phase 2, B: its update needs nothing of phase 1 but L11 and the
//     permutation, so it runs after it, off the chain: U12 = L11^{-1} P F12
//     by forward substitution, one thread a column of F12 (in registers,
//     static indices), L11 read from shared memory.  Row i of U12
//     subtracts L11[i, c] U12[c, :] for c = 0 .. i-1 in that order, which
//     is exactly what the in-place elimination subtracts from the row that
//     ends at position i, rounding for rounding.
//   * Loads and stores: each warp moves its 32 rows of A and of L21
//     through its own shared-memory tile in whole lines (no block
//     barrier); lu leaves through the L11 tile, F12 and U12 move a column
//     a thread, so a warp reads and writes whole lines.  No integer
//     division by a runtime value.
//   * Several small fronts share a CTA (a front is a whole number of warps,
//     fronts per CTA chosen by the wrapper, ops/front_lu.py k3_layout) so
//     that the steps of different fronts overlap.  A CTA holds at most
//     MAXT threads, the rows whose registers fit without spilling (a
//     warp's share of an SM sub-partition's 16 K registers); the wrapper
//     refuses taller fronts, and the routing sends them to the library.
//     The wrapper routes without a GPU, so it keeps a copy of MAXT and of
//     the shared-memory layout; lu_cross_capacity reports this file's
//     values for the two to be held against each other.
#include <cuda_runtime.h>
#include <cstdint>

#include "lu_common.cuh"

namespace {

using lu::div_rn;
using lu::mul_rn;
using lu::sub_rn;

constexpr size_t SMEM_LIMIT = 232448;       // H100 dynamic shared memory per block
constexpr int MAX_FPC = 8;                  // fronts per CTA: barrier ids 1..8

// the staging chunk: WB halved until a row of it is at most 128 bytes
constexpr int chunk(int wb, int size) {
  return wb * size <= 128 ? wb : chunk(wb / 2, size);
}

template <typename T, int WB>
struct Cfg {
  static constexpr int CH = chunk(WB, (int)sizeof(T));
  static constexpr int NWT = (WB + 31) / 32;        // warps holding rows < s
  static constexpr int LP = WB + 16 / (int)sizeof(T);  // L11 tile pitch
  // threads per CTA, at most: the __launch_bounds__ that leave a thread
  // the registers its row needs without spilling (ptxas, sm_90a: a CTA's
  // warps share out each sub-partition's 16 K registers, so 384 threads
  // get 168 a thread, 512 get 128, 1024 get 64)
  static constexpr int MAXT = sizeof(T) == 4
      ? (WB <= 16 ? 1024 : WB <= 48 ? 512 : 384)
      : (WB <= 8 ? 768 : WB <= 24 ? 512 : WB == 32 ? 384 : 256);
};

// 16-byte vectors of a shared-memory row: 4 floats or 2 doubles
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int N = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int N = 2; };

template <int E>
__device__ __forceinline__ float elem(const float4& w) {
  return E == 0 ? w.x : E == 1 ? w.y : E == 2 ? w.z : w.w;
}
template <int E>
__device__ __forceinline__ double elem(const double2& w) {
  return E == 0 ? w.x : w.y;
}

// row[j] = v[j] for the columns j >= J (and the rest of J's vector): the
// row is 16-byte aligned in shared memory
template <int J, typename T, int WB>
__device__ __forceinline__ void put_row(T* row, const T (&v)[WB]) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::N;
  lu::static_for<J / N, WB / N>([&](auto ci) {
    constexpr int c = decltype(ci)::value;
    V w;
    if constexpr (N == 4) w = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    else w = make_double2(v[2 * c], v[2 * c + 1]);
    reinterpret_cast<V*>(row)[c] = w;
  });
}

// v[j] = v[j] - m * row[j] for the columns j > J, the row read from shared
// memory in 16-byte vectors.  The empty asm with a memory clobber every 16
// values keeps the compiler from hoisting all of a wide row's loads ahead
// of the arithmetic, which would spill.
template <int J, typename T, int WB>
__device__ __forceinline__ void update_after(T (&v)[WB], T m, const T* row) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::N;
  lu::static_for<(J + 1) / N, WB / N>([&](auto ci) {
    constexpr int c = decltype(ci)::value;
    const V w = reinterpret_cast<const V*>(row)[c];
    lu::static_for<0, N>([&](auto ei) {
      constexpr int e = decltype(ei)::value, j = c * N + e;
      if constexpr (j > J) v[j] = sub_rn(v[j], mul_rn(m, elem<e>(w)));
    });
    if constexpr ((c * N) % 16 == 16 - N) asm volatile("" ::: "memory");
  });
}

// acc - row[0] b[0] - row[1] b[1] - ... - row[Q-1] b[Q-1], term by term in
// that order, the row read in 16-byte vectors as in update_after
template <int Q, typename T, int WB>
__device__ __forceinline__ T sub_dot(T acc, const T* row, const T (&b)[WB]) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::N;
  lu::static_for<0, (Q + N - 1) / N>([&](auto ci) {
    constexpr int c = decltype(ci)::value;
    const V w = reinterpret_cast<const V*>(row)[c];
    lu::static_for<0, N>([&](auto ei) {
      constexpr int e = decltype(ei)::value, j = c * N + e;
      if constexpr (j < Q) acc = sub_rn(acc, mul_rn(elem<e>(w), b[j]));
    });
    if constexpr ((c * N) % 16 == 16 - N) asm volatile("" ::: "memory");
  });
  return acc;
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// byte offsets of one front's shared memory
struct Layout {
  size_t stage, ls, u, keys, rows, perm, total;
};

template <typename T, int WB>
__host__ __device__ Layout layout(int nw, int s) {
  using C = Cfg<T, WB>;
  using K = lu::pivot_key_t<T>;
  Layout L{};
  size_t o = 0;
  L.stage = o; o = align16(o + (size_t)nw * 32 * (C::CH + 1) * sizeof(T));  // [warp][32][CH+1]
  L.ls = o;    o = align16(o + (size_t)s * C::LP * sizeof(T));              // L11 [s][LP]
  L.u = o;     o = align16(o + 2 * WB * sizeof(T));                         // pivot row [2][WB]
  L.keys = o;  o = align16(o + 2 * C::NWT * sizeof(K));                     // per-warp best
  L.rows = o;  o = align16(o + 2 * C::NWT * sizeof(int));
  L.perm = o;  o = align16(o + WB * sizeof(int));                           // perm [WB]
  L.total = o;
  return L;
}

template <typename T, int WB>
__global__ void __launch_bounds__(Cfg<T, WB>::MAXT, 1)
lu_cross_kernel(const T* __restrict__ F, T* __restrict__ lu,
                T* __restrict__ L21, T* __restrict__ U12,
                int64_t* __restrict__ perm, int64_t nf, int p, int s, int nw,
                T thresh, int pivot) {
  using C = Cfg<T, WB>;
  using K = lu::pivot_key_t<T>;
  constexpr int CH = C::CH, NWT = C::NWT, LP = C::LP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = nw * 32;                   // threads of one front
  const int grp = threadIdx.x / nt;         // the front within the CTA
  const int t = threadIdx.x % nt;           // this thread's row of A
  const int lane = t & 31, warp = t >> 5;
  const int64_t f = (int64_t)blockIdx.x * (blockDim.x / nt) + grp;
  if (f >= nf) return;                      // the whole front group leaves
  const int u = p - s;
  const int nwt = (s + 31) >> 5;            // warps holding rows < s

  const Layout lo = layout<T, WB>(nw, s);
  unsigned char* base = smem + (size_t)grp * lo.total;
  T* stage = reinterpret_cast<T*>(base + lo.stage) + warp * 32 * (CH + 1);
  T* Ls = reinterpret_cast<T*>(base + lo.ls);
  T* U = reinterpret_cast<T*>(base + lo.u);
  K* sk = reinterpret_cast<K*>(base + lo.keys);
  int* si = reinterpret_cast<int*>(base + lo.rows);
  int* P = reinterpret_cast<int*>(base + lo.perm);
  const int bar_id = 1 + grp;               // 0 is __syncthreads'
  auto sync = [bar_id, nt] {
    asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(nt) : "memory");
  };
  const T* Ff = F + f * p * p;
  const int r0 = warp * 32;                 // the warp's first row

  // ---- A's rows into registers, through the warp's tile ----
  T v[WB];
  lu::static_for<0, WB / CH>([&](auto ci) {
    constexpr int c0 = decltype(ci)::value * CH;
#pragma unroll 8
    for (int e = lane; e < 32 * CH; e += 32) {
      const int r = e / CH, j = e % CH;
      stage[r * (CH + 1) + j] = r0 + r < p && c0 + j < s
                                    ? Ff[(int64_t)(r0 + r) * p + c0 + j]
                                    : T(0);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CH; ++j) v[c0 + j] = stage[lane * (CH + 1) + j];
    __syncwarp();
  });
  int pos = t;                              // the row's current position

  // ---- phase 1: eliminate A, one step a column, k a compile-time
  // constant: column k is a register, the update touches columns > k only
  lu::static_for<0, WB>([&](auto ki) {
    constexpr int k = decltype(ki)::value;
    constexpr int buf = k & 1;
    if (k < s) {
      const T x = v[k];
      int rp = k;                           // the pivot row's position
      if (pivot && warp < nwt) {
        K key = t < s && pos >= k ? lu::pivot_key(x) : K(0);
        int bp = key ? pos : lu::NO_ROW;
        lu::warp_best(key, bp);
        if (nwt > 1) {
          if (lane == 0) { sk[buf * NWT + warp] = key; si[buf * NWT + warp] = bp; }
        } else {
          rp = bp;
        }
      }
      if (pivot && nwt > 1) {               // join the candidates of the warps
        sync();
        if (warp < nwt) {
          K key = sk[buf * NWT];
          int bp = si[buf * NWT];
#pragma unroll
          for (int q = 1; q < NWT; ++q) {
            const K kq = sk[buf * NWT + q];
            const int iq = si[buf * NWT + q];
            if (q < nwt && (kq > key || (kq == key && iq < bp))) { key = kq; bp = iq; }
          }
          rp = bp;
        }
      }
      // only a row < s can hold position rp (< s); rows >= s keep theirs
      const bool is_piv = pos == rp;
      if (is_piv) put_row<k>(U + buf * WB, v);
      sync();

      const T* ur = U + buf * WB;
      const T piv = lu::replace_tiny(ur[k], thresh);
      // the swap: the pivot row takes position k, the row at k takes rp
      if (is_piv) pos = k;
      else if (pos == k) pos = rp;
      const bool upd = pos > k && t < p;
      const T m = div_rn(x, piv);
      v[k] = upd ? m : (is_piv ? piv : x);
      // rows at positions <= k are not touched (a NaN in the pivot row
      // stays out of them, as in the plain version)
      if (upd) update_after<k>(v, m, ur);
    }
  });

  // ---- outputs of phase 1 ----
  // rows < s: L\U into the L11 tile at their positions, and the permutation
  if (t < s) {
    put_row<0>(Ls + pos * LP, v);
    P[pos] = t;
  }
  // rows >= s: L21, through the warp's tile
  T* L21f = L21 + f * u * s;
  lu::static_for<0, WB / CH>([&](auto ci) {
    constexpr int c0 = decltype(ci)::value * CH;
#pragma unroll
    for (int j = 0; j < CH; ++j) stage[lane * (CH + 1) + j] = v[c0 + j];
    __syncwarp();
#pragma unroll 4
    for (int e = lane; e < 32 * CH; e += 32) {
      const int r = e / CH, j = e % CH;
      const int row = r0 + r;
      if (row >= s && row < p && c0 + j < s)
        L21f[(int64_t)(row - s) * s + c0 + j] = stage[r * (CH + 1) + j];
    }
    __syncwarp();
  });
  sync();
  T* luf = lu + f * s * s;
  for (int e = t; e < s * WB; e += nt) {
    const int r = e / WB, j = e % WB;
    if (j < s) luf[r * s + j] = Ls[r * LP + j];
  }
  for (int e = t; e < s; e += nt) perm[f * s + e] = P[e];

  // ---- phase 2: U12 = L11^{-1} P F12, one column a thread ----
  if (t < u) {
    T b[WB];
#pragma unroll
    for (int q = 0; q < WB; ++q)
      b[q] = q < s ? Ff[(int64_t)P[q] * p + s + t] : T(0);
    lu::static_for<1, WB>([&](auto qi) {
      constexpr int q = decltype(qi)::value;
      if (q < s) b[q] = sub_dot<q>(b[q], Ls + q * LP, b);
    });
    T* Uf = U12 + f * s * u;
#pragma unroll
    for (int q = 0; q < WB; ++q)
      if (q < s) Uf[(int64_t)q * u + t] = b[q];
  }
}

template <typename T, int WB>
int launch_wb(const void* F, void* lu, void* L21, void* U12, void* perm,
              int64_t nf, int p, int s, double thresh, int pivot, int nw,
              int fpc, cudaStream_t stream) {
  using C = Cfg<T, WB>;
  const int threads = fpc * nw * 32;
  const size_t smem = layout<T, WB>(nw, s).total * fpc;
  if (s > WB || nw * 32 < p || threads > C::MAXT || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;             // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        lu_cross_kernel<T, WB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  lu_cross_kernel<T, WB><<<(unsigned)((nf + fpc - 1) / fpc), threads, smem,
                           stream>>>(
      (const T*)F, (T*)lu, (T*)L21, (T*)U12, (int64_t*)perm, nf, p, s, nw,
      (T)thresh, pivot);
  return (int)cudaGetLastError();
}

// wb, nw, fpc: the width bucket (8, 16, 24, 32, 48 or 64, >= s), the warps of one
// front (32 nw >= p) and the fronts per CTA the wrapper chose
template <typename T>
int launch(const void* F, void* lu, void* L21, void* U12, void* perm,
           int64_t nf, int p, int s, double thresh, int pivot, int wb, int nw,
           int fpc, void* stream_) {
  if (nf == 0) return 0;
  if (s <= 0 || s >= p || nw <= 0 || fpc < 1 || fpc > MAX_FPC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  switch (wb) {
    case 8: return launch_wb<T, 8>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, nw, fpc, stream);
    case 16: return launch_wb<T, 16>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, nw, fpc, stream);
    case 24: return launch_wb<T, 24>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, nw, fpc, stream);
    case 32: return launch_wb<T, 32>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, nw, fpc, stream);
    case 48: return launch_wb<T, 48>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, nw, fpc, stream);
    case 64: return launch_wb<T, 64>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, nw, fpc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int WB>
int capacity_wb(int nw, int s, int64_t* out) {
  out[0] = Cfg<T, WB>::MAXT;
  out[1] = (int64_t)layout<T, WB>(nw, s).total;
  out[2] = (int64_t)SMEM_LIMIT;
  out[3] = MAX_FPC;
  return 0;
}

template <typename T>
int capacity(int wb, int nw, int s, int64_t* out) {
  switch (wb) {
    case 8: return capacity_wb<T, 8>(nw, s, out);
    case 16: return capacity_wb<T, 16>(nw, s, out);
    case 24: return capacity_wb<T, 24>(nw, s, out);
    case 32: return capacity_wb<T, 32>(nw, s, out);
    case 48: return capacity_wb<T, 48>(nw, s, out);
    case 64: return capacity_wb<T, 64>(nw, s, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// What the kernel holds at width bucket wb, for the wrapper's copy of it
// (ops/front_lu.py K3_MAX_THREADS, k3_smem, SMEM_LIMIT, K3_MAX_FPC, which
// route fronts without a GPU): out = {threads a CTA, shared bytes of one
// front of nw warps eliminating s columns, shared bytes a CTA, fronts a
// CTA}.  ``front_lu.k3_capacity_drift`` holds the two against each other.
int lu_cross_capacity(int itemsize, int wb, int nw, int s, int64_t* out) {
  if (itemsize == 4) return capacity<float>(wb, nw, s, out);
  if (itemsize == 8) return capacity<double>(wb, nw, s, out);
  return (int)cudaErrorInvalidValue;
}

int lu_cross_f32(const void* F, void* lu, void* L21, void* U12, void* perm,
                 int64_t nf, int p, int s, double thresh, int pivot, int wb,
                 int nw, int fpc, void* stream) {
  return launch<float>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, wb,
                       nw, fpc, stream);
}

int lu_cross_f64(const void* F, void* lu, void* L21, void* U12, void* perm,
                 int64_t nf, int p, int s, double thresh, int pivot, int wb,
                 int nw, int fpc, void* stream) {
  return launch<double>(F, lu, L21, U12, perm, nf, p, s, thresh, pivot, wb,
                        nw, fpc, stream);
}

const char* front_lu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
