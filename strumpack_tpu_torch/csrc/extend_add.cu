// K1: multifrontal extend-add of a whole bucket (or chunk of a bucket),
//   F[f, i, j] += C_k[idx_k[f], pos_k[f, i], pos_k[f, j]]
// for every pair k of the bucket's pair table, in the table's order.
//
// Replaces the TPU kernel strumpack_tpu/ops/pallas_extadd.py
// (extend_add_pallas -> _ea_kernel / _ea_kernel_big), which the JAX sweep
// calls once per (side, child bucket) pair.  Mosaic cannot gather, so that
// kernel rebuilt the scatter as one-hot window matmuls on the MXU.  Hopper
// gathers natively; the work is a pure data movement with one add an
// element, so it is bound by bytes at 3.35 TB/s: each parent element with
// an addend read and written once, each child entry read once.
//
// Semantics.  A pair k is (C_k [nfc, u, u], idx_k [nf], side): idx_k[f] is
// front f's block in C_k, -1 = none; side 0 takes the map posL, side 1
// posR, pos[f, i] = the child row of parent slot i, -1 = none.  F is
// updated IN PLACE (the JAX kernel aliased F to its output too).  A front
// has at most one pair of each side with idx >= 0 (its left and its right
// child), but both children can feed one parent element; each thread owns
// its parent elements and adds the addends of the front's pairs in table
// order (the plan's order: L pairs, then R pairs), so the result is
// bit-exact against the plain version applied pair by pair
// (ops/extend_add.py extend_add_bucket_plain).
//
// What bounds the work, and what the design does about it:
// * Fixed cost per launch.  The sweep used to make one launch per (side,
//   child bucket) pair, thousands a factorization of small fronts.  One
//   launch now covers the bucket: the pair table (each pair's C pointer,
//   u, idx pointer and side) goes in the kernel's parameter struct
//   (__grid_constant__), so a launch needs no host-to-device copy; the
//   wrapper splits a table longer than MAX_PAIRS over several launches,
//   in table order.
// * Work where there is none.  The plan caches, per front, the compact
//   list of parent slots that take an addend (the union of posL >= 0 and
//   posR >= 0 of the sides the front has), as rows, and the same set in
//   aligned groups of GS slots, as columns, plus a list of tiles (front,
//   first row, first group) of at most TR rows x TG groups over them
//   (ops/extend_add.py EAMap).  The grid is that list: identity padding
//   and slots that no child fills cost no block and no map traffic.
// * Bytes in flight.  A block stages its tile's row and column maps in
//   shared memory once; each thread then takes U items (a row x one
//   column group), issues all their F loads, then all the addend loads
//   of one pair through the read-only path, before it adds and stores.
//   F's group of GS slots is one 16-byte vector (f32) or two or four
//   (f64, complex64, complex128) when p is a multiple of GS and F is
//   16-byte aligned; otherwise slot by slot.
//
// Complex fronts (complex64, complex128) take the same kernel on a
// two-component element whose add is componentwise: the sum of two complex
// numbers rounds each part on its own, as PyTorch's complex add does, so
// these instantiations are bit-exact too.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// a complex value of real type R, laid out as PyTorch's complex R (real
// part first, aligned to its size)
template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
};

template <typename R>
__device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}

// Mirrored in ops/extend_add.py (EA_TILE_ROWS, EA_TILE_GROUPS, EA_GROUP,
// EA_MAX_PAIRS); the wrapper checks them against extend_add_config.
constexpr int TR = 32;         // compact rows a tile
constexpr int TG = 16;         // column groups a tile
constexpr int GS = 4;          // parent slots a column group
constexpr int MAX_PAIRS = 32;  // pairs a launch
constexpr int NT = 128;        // threads a block

struct Pair {
  const void* C;        // [nfc, u, u]
  const int32_t* idx;   // [nf] block of C, -1 = none
  int32_t u;
  int32_t side;         // 0: posL, 1: posR
};

struct Params {
  void* F;                  // [nf, p, p]
  const int32_t* pos[2];    // posL, posR [nf, p]
  const int32_t* rows;      // [nf, mr] filled slots, -1 padded
  const int32_t* groups;    // [nf, mg] filled column groups, -1 padded
  const int32_t* tiles;     // [ntiles, 3] front + f0, first row, group
  int64_t f0;
  int p, mr, mg, npairs, vec;
  Pair pair[MAX_PAIRS];
};

// __ldg of an element (the complex types as the vector of their parts)
template <typename T>
__device__ __forceinline__ T ldg(const T* p) { return __ldg(p); }
template <>
__device__ __forceinline__ cplx<float> ldg(const cplx<float>* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}
template <>
__device__ __forceinline__ cplx<double> ldg(const cplx<double>* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return {v.x, v.y};
}

template <typename T>
union Group {
  T e[GS];
  int4 q[GS * sizeof(T) / 16];
};

template <typename T>
__global__ void __launch_bounds__(NT)
    extend_add_bucket_kernel(const __grid_constant__ Params P) {
  __shared__ int32_t rslot[TR];
  __shared__ int32_t rpos[2][TR];
  __shared__ int32_t gslot[TG];
  __shared__ int32_t cpos[2][TG * GS];
  __shared__ int32_t act[MAX_PAIRS];   // the front's pairs, table order
  __shared__ int32_t actc[MAX_PAIRS];  // their blocks in C
  __shared__ int nact_s;
  const int t = threadIdx.x;
  const int32_t* tile = P.tiles + 3 * (int64_t)blockIdx.x;
  const int64_t f = __ldg(tile) - P.f0;
  const int r0 = __ldg(tile + 1), g0 = __ldg(tile + 2);
  const int p = P.p;
  const int64_t fp = f * p;

  // the pairs that feed this front, in table order (MAX_PAIRS <= 32: one
  // warp's ballot)
  if (t < 32) {
    const int c = t < P.npairs ? __ldg(P.pair[t].idx + f) : -1;
    const unsigned m = __ballot_sync(0xffffffffu, c >= 0);
    if (c >= 0) {
      const int k = __popc(m & ((1u << t) - 1u));
      act[k] = t;
      actc[k] = c;
    }
    if (t == 0) nact_s = __popc(m);
  }
  // the tile's rows and column groups with their child rows on each side
  int s = -1;
  if (t < TR) {
    s = r0 + t < P.mr ? __ldg(P.rows + f * P.mr + r0 + t) : -1;
    rslot[t] = s;
    rpos[0][t] = s >= 0 ? __ldg(P.pos[0] + fp + s) : -1;
    rpos[1][t] = s >= 0 ? __ldg(P.pos[1] + fp + s) : -1;
  }
  int g = -1;
  if (t < TG * GS) {
    const int k = t / GS;
    g = g0 + k < P.mg ? __ldg(P.groups + f * P.mg + g0 + k) : -1;
    const int sl = g * GS + t % GS;
    const bool in = g >= 0 && sl < p;
    cpos[0][t] = in ? __ldg(P.pos[0] + fp + sl) : -1;
    cpos[1][t] = in ? __ldg(P.pos[1] + fp + sl) : -1;
    if (t % GS == 0) gslot[k] = g >= 0 ? g * GS : -1;
  }
  // the lists are prefix-valid: counting the valid entries gives the
  // tile's extent (and is the barrier before the maps are read)
  const int nr = __syncthreads_count(t < TR && s >= 0);
  const int ng = __syncthreads_count(t < TG * GS && t % GS == 0 && g >= 0);
  const int nact = nact_s;
  // a launch that carries part of a long table may hold no pair of f
  if (nact == 0) return;
  const int n = nr * ng;

  T* F = static_cast<T*>(P.F) + f * p * (int64_t)p;
  // items a thread takes at once: 4 groups of 16 or 32 bytes, 2 of 64
  constexpr int U = sizeof(T) >= 16 ? 2 : 4;
  for (int base = 0; base < n; base += U * NT) {
    Group<T> v[U];
    int rr[U], gg[U];
    int64_t off[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int it = base + i * NT + t;
      rr[i] = -1;
      gg[i] = 0;
      off[i] = 0;
      if (it >= n) continue;
      rr[i] = it / ng;
      gg[i] = it % ng;
      off[i] = (int64_t)rslot[rr[i]] * p + gslot[gg[i]];
      if (P.vec) {
        const int4* src = reinterpret_cast<const int4*>(F + off[i]);
#pragma unroll
        for (int q = 0; q < (int)(GS * sizeof(T) / 16); ++q)
          v[i].q[q] = src[q];
      } else {
#pragma unroll
        for (int j = 0; j < GS; ++j)
          if (gslot[gg[i]] + j < p) v[i].e[j] = F[off[i] + j];
      }
    }
    for (int a = 0; a < nact; ++a) {
      const Pair& pr = P.pair[act[a]];
      const int u = pr.u, side = pr.side;
      const T* C = static_cast<const T*>(pr.C) + (int64_t)actc[a] * u * u;
      T add[U][GS];
      bool has[U][GS];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int ci = rr[i] >= 0 ? rpos[side][rr[i]] : -1;
#pragma unroll
        for (int j = 0; j < GS; ++j) {
          const int cj = ci >= 0 ? cpos[side][gg[i] * GS + j] : -1;
          has[i][j] = cj >= 0;
          if (cj >= 0) add[i][j] = ldg(C + (int64_t)ci * u + cj);
        }
      }
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int j = 0; j < GS; ++j)
          if (has[i][j]) v[i].e[j] = v[i].e[j] + add[i][j];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (rr[i] < 0) continue;
      if (P.vec) {
        int4* dst = reinterpret_cast<int4*>(F + off[i]);
#pragma unroll
        for (int q = 0; q < (int)(GS * sizeof(T) / 16); ++q)
          dst[q] = v[i].q[q];
      } else {
#pragma unroll
        for (int j = 0; j < GS; ++j)
          if (gslot[gg[i]] + j < p) F[off[i] + j] = v[i].e[j];
      }
    }
  }
}

// The launcher's argument vector, one int64 each (one ctypes argument
// instead of eighteen: the wrapper's host time is the small calls' time):
enum Arg { A_F, A_POSL, A_POSR, A_ROWS, A_GROUPS, A_TILES, A_NTILES, A_F0,
           A_P, A_MR, A_MG, A_VEC, A_STREAM, A_NPAIRS, A_PAIRS };
// then npairs x (C, idx, u, side) from A_PAIRS on

template <typename T>
int launch(const int64_t* a) {
  const int64_t ntiles = a[A_NTILES];
  const int npairs = (int)a[A_NPAIRS];
  if (npairs < 0 || npairs > MAX_PAIRS) return (int)cudaErrorInvalidValue;
  if (ntiles == 0 || npairs == 0) return 0;
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  Params P;
  P.F = reinterpret_cast<void*>(a[A_F]);
  P.pos[0] = reinterpret_cast<const int32_t*>(a[A_POSL]);
  P.pos[1] = reinterpret_cast<const int32_t*>(a[A_POSR]);
  P.rows = reinterpret_cast<const int32_t*>(a[A_ROWS]);
  P.groups = reinterpret_cast<const int32_t*>(a[A_GROUPS]);
  P.tiles = reinterpret_cast<const int32_t*>(a[A_TILES]);
  P.f0 = a[A_F0];
  P.p = (int)a[A_P];
  P.mr = (int)a[A_MR];
  P.mg = (int)a[A_MG];
  P.npairs = npairs;
  P.vec = (int)a[A_VEC];
  for (int k = 0; k < npairs; ++k) {
    const int64_t* q = a + A_PAIRS + 4 * k;
    P.pair[k] = Pair{reinterpret_cast<const void*>(q[0]),
                     reinterpret_cast<const int32_t*>(q[1]), (int32_t)q[2],
                     (int32_t)q[3]};
  }
  extend_add_bucket_kernel<T><<<(unsigned)ntiles, NT, 0,
                                reinterpret_cast<cudaStream_t>(
                                    a[A_STREAM])>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int extend_add_bucket_f32(const int64_t* a) { return launch<float>(a); }
int extend_add_bucket_f64(const int64_t* a) { return launch<double>(a); }
int extend_add_bucket_c64(const int64_t* a) {
  return launch<cplx<float>>(a);
}
int extend_add_bucket_c128(const int64_t* a) {
  return launch<cplx<double>>(a);
}

// TR, TG, GS and MAX_PAIRS, for the wrapper's check of its copies
void extend_add_config(int32_t* out) {
  out[0] = TR;
  out[1] = TG;
  out[2] = GS;
  out[3] = MAX_PAIRS;
}

const char* extend_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
