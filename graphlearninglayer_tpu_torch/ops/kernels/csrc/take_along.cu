// Kernel P2: take_along_axis with indices shaped like the operand.
//
//   axis 0: out[i, j] = x[idx[i, j], j]
//   axis 1: out[i, j] = x[i, idx[i, j]]
//
// x and out (m, n) float32, idx (m, n) int64, all row-major.  An index
// outside [0, m) (axis 0) or [0, n) (axis 1) gives NaN at its place and
// reads nothing.
//
// It replaces the Pallas TPU probe benchmarks/probe_gather_support.py:19
// (try_case), which asked which shapes Mosaic compiles jnp.take_along_axis
// for inside a kernel, along the sublane (0) or the lane (1) axis.  No
// path of the port needs it; the counterpart answers the question on the
// H100, where either axis is a plain gather from device memory.
//
// Bound.  It reads x and idx once and writes out once, 16 m n bytes, and
// does no arithmetic: bound by bytes, 40 us for the probe's largest case
// (65,536 x 128, 134 MB) at 3.35 TB/s.
//
// Design.  One thread an output element, grid-stride, consecutive threads
// on consecutive elements of a row: idx and out move in full coalesced
// lines, and so do the reads of x along axis 0 where the indices of a row
// are close (a row of x is read at row idx[i, j], column j); along axis 1
// every read stays inside row i of x, which the block's neighbours share
// in L1 and L2.
#include <cuda_runtime.h>

namespace {

template <int kAxis>
__global__ void take_along_kernel(const float* __restrict__ x,
                                  const long long* __restrict__ idx,
                                  float* __restrict__ out, int m, int n) {
  const long long total = (long long)m * n;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / n, j = e - i * n;
    const long long t = __ldg(idx + e);
    const long long bound = kAxis == 0 ? m : n;
    float v = __int_as_float(0x7fc00000);   // NaN
    if (t >= 0 && t < bound)
      v = __ldg(x + (kAxis == 0 ? t * n + j : i * n + t));
    out[e] = v;
  }
}

}  // namespace

// out = take_along_axis(x, idx, axis) (see above); m, n >= 1, axis 0 or 1.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gll_take_along_f32(const void* x, const void* idx, void* out,
                                  int m, int n, int axis, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)m * n;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  if (axis == 0) {
    take_along_kernel<0><<<(int)blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const long long*>(idx),
        static_cast<float*>(out), m, n);
  } else {
    take_along_kernel<1><<<(int)blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const long long*>(idx),
        static_cast<float*>(out), m, n);
  }
  return static_cast<int>(cudaGetLastError());
}
