// Kernel P1: an in-block bitonic sort of each row, and a block gated on a
// reduced scalar.
//
// gll_row_sort_f32: x (Q, M) float32 row-major, M a power of two up to
// 1,024.  Each row is sorted by the key (value, column index), ascending,
// or with descending = 1 by (-value, column index), so that of equal values
// the lower index comes first either way; NaN counts as larger than every
// number (last ascending, first descending), -0.0 as equal to +0.0: the
// order of torch.sort(..., stable=True).  Writes the sorted values (Q, M)
// float32 and their column indices (Q, M) int64.
//
// gll_scale_if_max_positive_f32: out = 2 x where max(x) > 0 over the whole
// array, else x (a NaN anywhere makes the max NaN, and then out = x).
//
// It replaces the Pallas TPU probe benchmarks/probe_pallas_sort.py:25
// (run), which asked whether Mosaic compiles a lane-dimension sort,
// lax.top_k over a whole row, a hand-written bitonic compare-exchange
// network (k_bitonic) and pl.when gated on a reduced scalar (k_when), on a
// 256 x 512 float32 block.  No path of the port sorts rows this way; the
// counterpart answers the same question on the H100.
//
// Bound.  The sort reads x once (4 Q M bytes) and writes values and
// indices once (12 Q M bytes); its M/2 log2 M (log2 M + 1) / 2 compare-
// exchanges a row are far below the card's rate, so it is bound by bytes:
// 0.63 us at 256 x 512.  The gated scale reads x once and writes it once.
//
// Design.  One block a row: the row's values and indices sit in shared
// memory (8 KB at M = 1,024), each thread takes M / 2 / blockDim pairs of
// every stage of the network, and a block barrier separates the stages.
// The network is the probe's (partner = i XOR j, direction from bit k),
// with keys that are unique (the index breaks ties), so its output is the
// one total order whatever the network.  The gated scale is two kernels:
// the first ORs "some element > 0" and "some element is NaN" into a flag
// word, warp by warp, the second scales where the flag says so.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 1024;

// true when (va, ia) comes strictly before (vb, ib)
template <bool kDescending>
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) {
    if (na && nb) return ia < ib;
    return kDescending ? na : nb;
  }
  if (va == vb) return ia < ib;
  return kDescending ? va > vb : va < vb;
}

template <bool kDescending>
__global__ void row_sort_kernel(const float* __restrict__ x,
                                float* __restrict__ vals,
                                long long* __restrict__ idx, int m) {
  __shared__ float sv[kMaxM];
  __shared__ int si[kMaxM];
  const long long base = (long long)blockIdx.x * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sv[i] = x[base + i];
    si[i] = i;
  }
  __syncthreads();
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (m >> 1); p += blockDim.x) {
        // the p-th pair of the stage: a has bit j clear, b = a | j
        const int a = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int b = a | j;
        const bool up = (a & k) == 0;   // this block of k sorts ascending
        const float va = sv[a], vb = sv[b];
        const int ia = si[a], ib = si[b];
        if (before<kDescending>(vb, ib, va, ia) == up) {
          sv[a] = vb; sv[b] = va;
          si[a] = ib; si[b] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    vals[base + i] = sv[i];
    idx[base + i] = si[i];
  }
}

__global__ void positive_or_nan_kernel(const float* __restrict__ x,
                                       long long n, unsigned* flag) {
  unsigned bits = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    bits |= (v > 0.0f ? 1u : 0u) | (isnan(v) ? 2u : 0u);
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(flag, bits);
}

__global__ void scale_by_flag_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, long long n,
                                     const unsigned* flag) {
  const float f = (*flag == 1u) ? 2.0f : 1.0f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = x[i] * f;
}

int grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

}  // namespace

// vals, idx = the rows of x sorted (see above); q >= 1, m a power of two in
// [1, 1024].  Returns the launch's cudaError_t (0 on success).
extern "C" int gll_row_sort_f32(const void* x, void* vals, void* idx, int q,
                                int m, int descending, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int threads = m / 2 < 32 ? 32 : (m / 2 > 512 ? 512 : m / 2);
  if (descending) {
    row_sort_kernel<true><<<q, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(vals),
        static_cast<long long*>(idx), m);
  } else {
    row_sort_kernel<false><<<q, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(vals),
        static_cast<long long*>(idx), m);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = 2 x if max(x) > 0 else x, over n >= 1 elements; flag is one
// unsigned word of scratch.  Returns the first cudaError_t (0 on success).
extern "C" int gll_scale_if_max_positive_f32(const void* x, void* out,
                                             void* flag, long long n,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  positive_or_nan_kernel<<<grid_for(n, 256), 256, 0, st>>>(
      static_cast<const float*>(x), n, static_cast<unsigned*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scale_by_flag_kernel<<<grid_for(n, 256), 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n,
      static_cast<const unsigned*>(flag));
  return static_cast<int>(cudaGetLastError());
}
