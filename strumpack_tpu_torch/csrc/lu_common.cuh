// Arithmetic and pivot order shared by the LU kernels K2 (small_lu.cu),
// K3 (front_lu.cu) and K4 (panel_lu.cu).
//
// Every update is a separately rounded multiply and subtract (nvcc would
// otherwise contract a - m * u into an FMA), and every multiplier a
// correctly rounded division: the kernels then repeat the rounding of
// their plain PyTorch versions bit for bit, and no near-tie pivot flips
// between the two.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace lu {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// The tiny-pivot rule of K2, K3 and K4: |piv| < thresh -> thresh (piv == 0)
// or copysign(thresh, piv) (SparseSolverBase.cpp:346-350).
template <typename T>
__device__ __forceinline__ T replace_tiny(T piv, T thresh) {
  if (fabs(piv) < thresh) return piv == T(0) ? thresh : copysign(thresh, piv);
  return piv;
}

// static_for<B, E>(f) calls f(Index<B>{}), ..., f(Index<E-1>{}): a loop
// whose counter is a compile-time constant, so that register arrays
// indexed through it stay in registers.
template <int N>
struct Index { static constexpr int value = N; };

template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(Index<B>{});
    static_for<B + 1, E>(f);
  }
}

// ---------------------------------------------------------------------------
// The pivot order: larger |value| wins, NaN counts as the largest
// (torch.argmax's order), the lower row index wins a tie.  pivot_key(x)
// maps a candidate to an unsigned key in that order on |x| -- the bits of a
// non-negative float order as its value, every NaN becomes one key above
// +inf, 0 is left for "no candidate" -- so that a warp finds its pivot
// with its integer reductions (__reduce_*_sync, one instruction each), and
// any reduction tree gives the same winner.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pivot_key(float x) {
  const float a = fabsf(x);
  return isnan(a) ? 0x7FC00001u : __float_as_uint(a) + 1u;
}

__device__ __forceinline__ uint64_t pivot_key(double x) {
  const double a = fabs(x);
  return isnan(a) ? 0x7FF8000000000001ull
                  : (uint64_t)__double_as_longlong(a) + 1ull;
}

template <typename T>
using pivot_key_t = decltype(pivot_key(T(0)));
constexpr int NO_ROW = INT_MAX;

// every lane ends with the warp's largest key and the lowest row holding it
__device__ __forceinline__ void warp_best(uint32_t& key, int& row) {
  const uint32_t mk = __reduce_max_sync(0xffffffffu, key);
  row = (int)__reduce_min_sync(0xffffffffu,
                               key == mk ? (unsigned)row : 0xffffffffu);
  key = mk;
}

__device__ __forceinline__ void warp_best(uint64_t& key, int& row) {
  const uint32_t hi = (uint32_t)(key >> 32), lo = (uint32_t)key;
  const uint32_t mh = __reduce_max_sync(0xffffffffu, hi);
  const uint32_t ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  row = (int)__reduce_min_sync(
      0xffffffffu, hi == mh && lo == ml ? (unsigned)row : 0xffffffffu);
  key = ((uint64_t)mh << 32) | ml;
}

// ---------------------------------------------------------------------------
// Rows in registers, loaded and stored through a shared-memory tile so that
// device memory is read and written in whole lines.  A group of nt threads
// holds rows [0, nrows) of a row-major block with leading dimension ld (its
// first ncols columns valid): thread t holds row t / S, columns
// h, h + S, h + 2S, ... (h = t % S) in v[CW].  The tile is stage[rows][CH+1]
// (the +1 spreads a column over the banks); CH columns at a time, each
// chunk between two group barriers sync().
// ---------------------------------------------------------------------------

template <typename T, int S, int CH, int CW, typename Sync>
__device__ __forceinline__ void load_rows(T (&v)[CW], const T* __restrict__ src,
                                          int ld, int nrows, int ncols,
                                          T* stage, int t, int nt,
                                          Sync&& sync) {
  static_assert((CW * S) % CH == 0, "whole chunks");
  const int row = t / S, h = t % S;
  static_for<0, CW * S / CH>([&](auto ci) {
    constexpr int c0 = decltype(ci)::value * CH;
    for (int e = t; e < nrows * CH; e += nt) {
      const int r = e / CH, jj = e % CH;
      stage[r * (CH + 1) + jj] =
          c0 + jj < ncols ? src[(int64_t)r * ld + c0 + jj] : T(0);
    }
    sync();
#pragma unroll
    for (int jj = 0; jj < CH; ++jj)
      if ((c0 + jj) % S == h)
        v[(c0 + jj) / S] = row < nrows ? stage[row * (CH + 1) + jj] : T(0);
    sync();
  });
}

// the inverse: thread t writes its registers to row my_row of the block
// (my_row >= nrows: nothing)
template <typename T, int S, int CH, int CW, typename Sync>
__device__ __forceinline__ void store_rows(const T (&v)[CW], T* __restrict__ dst,
                                           int ld, int nrows, int ncols,
                                           int my_row, T* stage, int t,
                                           int nt, Sync&& sync) {
  const int h = t % S;
  static_for<0, CW * S / CH>([&](auto ci) {
    constexpr int c0 = decltype(ci)::value * CH;
#pragma unroll
    for (int jj = 0; jj < CH; ++jj)
      if ((c0 + jj) % S == h && my_row < nrows)
        stage[my_row * (CH + 1) + jj] = v[(c0 + jj) / S];
    sync();
    for (int e = t; e < nrows * CH; e += nt) {
      const int r = e / CH, jj = e % CH;
      if (c0 + jj < ncols) dst[(int64_t)r * ld + c0 + jj] = stage[r * (CH + 1) + jj];
    }
    sync();
  });
}

}  // namespace lu
