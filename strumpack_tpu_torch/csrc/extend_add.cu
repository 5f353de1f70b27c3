// K1: multifrontal extend-add, F[f, i, j] += C[idx[f], pos[f, i], pos[f, j]].
//
// Replaces the TPU kernel strumpack_tpu/ops/pallas_extadd.py
// (extend_add_pallas -> _ea_kernel / _ea_kernel_big).  Mosaic cannot gather,
// so the TPU kernel rebuilt the scatter as one-hot window matmuls on the MXU
// and split whole-CB-in-VMEM from windowed-DMA variants.  Hopper gathers
// natively, so this is the plain scatter of the reference's batched
// extend_add_kernel (FrontCUDA.cu:115): no flops, one kernel for every
// (p, u), no p % 64 / u >= 64 gates.
//
// Semantics (the gather form of strumpack_tpu/frontal/numeric.py:361-369):
//   pos[f, i] is the inverse map, parent slot i -> child row, -1 = none;
//   idx[f] is the front's child block in C, -1 = no child in this C.
// F is updated IN PLACE (the JAX kernel aliased F to its output too): only
// the (i, j) with pos[f, i] >= 0 and pos[f, j] >= 0 are read and written.
// Each such element receives exactly one addend, so the result is
// bit-exact against the gather form.
//
// Bound: bytes.  The work is nvalid^2 * (read F, read C, write F) per front
// with no arithmetic to speak of.  Design: one block per (front, 16-row
// tile, column tile); the tile's row and column maps are staged in shared
// memory once; threads run along j, so the F row segment is read and
// written coalesced and the C row segment is read in order (pos is order
// preserving along j).  Rows with pos < 0 are skipped before any F traffic.
//
// Complex fronts (complex64, complex128) take the same kernel on a
// two-component element whose add is componentwise: the sum of two complex
// numbers rounds each part on its own, as the gather form's complex add
// does, so these instantiations are bit-exact too.
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

constexpr int TI = 16;      // parent rows per block
constexpr int TJ_MAX = 128; // parent columns per block (= max blockDim.x)

template <typename T>
__global__ void extend_add_kernel(T* __restrict__ F, const T* __restrict__ C,
                                  const int32_t* __restrict__ idx,
                                  const int32_t* __restrict__ pos,
                                  int64_t f0, int p, int u) {
  __shared__ int32_t pi[TI];
  __shared__ int32_t pj[TJ_MAX];
  const int64_t f = f0 + blockIdx.z;
  const int c = idx[f];
  if (c < 0) return;  // whole block: no child of this front in C
  const int i0 = blockIdx.y * TI;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t* pf = pos + f * p;
  if (threadIdx.x < TI) {
    const int i = i0 + threadIdx.x;
    pi[threadIdx.x] = i < p ? pf[i] : -1;
  }
  pj[threadIdx.x] = j < p ? pf[j] : -1;
  __syncthreads();
  const int cj = pj[threadIdx.x];
  if (cj < 0) return;  // no later __syncthreads
  const T* Cf = C + (int64_t)c * u * u;
  T* Ff = F + f * p * p;
  const int ni = min(TI, p - i0);
  for (int r = 0; r < ni; ++r) {
    const int ci = pi[r];
    if (ci < 0) continue;
    T* fp = Ff + (int64_t)(i0 + r) * p + j;
    *fp = *fp + Cf[(int64_t)ci * u + cj];
  }
}

template <typename T>
int launch(void* F, const void* C, const void* idx, const void* pos,
           int64_t nf, int p, int u, void* stream) {
  if (nf == 0 || p == 0) return 0;
  const int tj = p < TJ_MAX ? ((p + 31) / 32) * 32 : TJ_MAX;
  const dim3 block(tj);
  const int gx = (p + tj - 1) / tj, gy = (p + TI - 1) / TI;
  for (int64_t f0 = 0; f0 < nf; f0 += 65535) {  // gridDim.z limit
    const int nz = (int)(nf - f0 < 65535 ? nf - f0 : 65535);
    extend_add_kernel<T><<<dim3(gx, gy, nz), block, 0,
                           (cudaStream_t)stream>>>(
        (T*)F, (const T*)C, (const int32_t*)idx, (const int32_t*)pos, f0, p,
        u);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

int extend_add_f32(void* F, const void* C, const void* idx, const void* pos,
                   int64_t nf, int p, int u, void* stream) {
  return launch<float>(F, C, idx, pos, nf, p, u, stream);
}

int extend_add_f64(void* F, const void* C, const void* idx, const void* pos,
                   int64_t nf, int p, int u, void* stream) {
  return launch<double>(F, C, idx, pos, nf, p, u, stream);
}

int extend_add_c64(void* F, const void* C, const void* idx, const void* pos,
                   int64_t nf, int p, int u, void* stream) {
  return launch<cplx<float>>(F, C, idx, pos, nf, p, u, stream);
}

int extend_add_c128(void* F, const void* C, const void* idx, const void* pos,
                    int64_t nf, int p, int u, void* stream) {
  return launch<cplx<double>>(F, C, idx, pos, nf, p, u, stream);
}

const char* extend_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
