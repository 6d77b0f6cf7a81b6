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
// (65,536 x 128, 134 MB) at 3.35 TB/s.  Along axis 0 with indices spread
// over every row, each gather also fetches its own 32-byte L2 sector
// (8 times the bytes it uses), which the bound does not count.
//
// Design.  A thread takes one 4-element unit of a row: it loads the
// unit's 4 indices as two 16-byte vectors with a streaming (evict-first)
// load, issues its 4 gathers before it uses any, and writes the unit as
// one float4 with a streaming store.  A block holds blockDim.y rows of
// one slab, blockDim.x consecutive units of each row, so a thread finds
// its row and columns with no division.  Along axis 0 a slab is narrow
// (at most kSlabElems elements of x, 32 columns at m = 65,536) and the
// blocks are ordered slab by slab: the blocks in flight gather from one
// slab of x, a few MB that stay in L2 while its ~8 gathers a sector come,
// where a row-major order spreads them over all of x (33.5 MB at the
// largest case), more than the L2 keeps between two uses.  Along axis 1
// every gather stays inside row i of x, and a slab is the whole row up to
// 128 columns.  (An L2 evict_last policy on the gathers, given per load,
// gained nothing in either order, and is not used.)  Row i's units start at the first column where out is
// 16-byte aligned; the columns before (the head, fewer than 4) and after
// the last whole unit (the tail) are scalar, so a view with a storage
// offset and any n work.  idx is loaded as vectors where it is 16-byte
// aligned at the same columns as out, else as scalars.  An out-of-range
// index predicates its load off.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// along axis 0, the columns a slab holds: at most kSlabElems elements of x
// (m rows x the slab's width), so that the blocks working at once gather
// from a few MB of x, which stays in L2 while it is used
constexpr long long kSlabElems = 1 << 21;   // 8 MB of float32

// v = *p when ok; v untouched (NaN) and nothing read otherwise
__device__ __forceinline__ void gather(float& v, const float* p, bool ok) {
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "+f"(v)
      : "l"(p), "r"((int)ok));
}

template <int kAxis>
__device__ __forceinline__ const float* source(const float* x, long long i,
                                               long long j, long long t,
                                               int n) {
  return kAxis == 0 ? x + t * n + j : x + i * n + t;
}

// block b: slab b / bands (blockDim.x 4-element units of each row's body),
// band b % bands (blockDim.y rows); consecutive blocks share a slab
template <int kAxis>
__global__ void __launch_bounds__(kThreads)
    take_along_kernel(const float* __restrict__ x,
                      const long long* __restrict__ idx,
                      float* __restrict__ out, int m, int n, int out_off,
                      int idx_vec, unsigned bands) {
  const unsigned slab = blockIdx.x / bands, band = blockIdx.x - slab * bands;
  const long long i = (long long)band * blockDim.y + threadIdx.y;
  if (i >= m) return;
  const float nan = __int_as_float(0x7fc00000);
  const long long bound = kAxis == 0 ? m : n;
  const long long row = i * n;
  // the head: columns [0, h) before out's first 16-byte boundary
  const int h = min((4 - ((out_off + (int)(row & 3)) & 3)) & 3, n);
  const int units = (n - h) / 4;
  if (slab == 0) {   // the head and the tail (after the last whole unit)
    const int tail = h + 4 * units;
    for (int c = threadIdx.x; c < 8; c += blockDim.x) {
      const int j = c < 4 ? (c < h ? c : n) : tail + c - 4;
      if (j >= n) continue;
      const long long t = __ldcs(idx + row + j);
      float v = nan;
      gather(v, source<kAxis>(x, i, j, t, n), t >= 0 && t < bound);
      __stcs(out + row + j, v);
    }
  }
  const int u = slab * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int j = h + 4 * u;
  long long t[4];
  if (idx_vec) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(idx + row + j));
    const longlong2 b =
        __ldcs(reinterpret_cast<const longlong2*>(idx + row + j + 2));
    t[0] = a.x; t[1] = a.y; t[2] = b.x; t[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) t[c] = __ldcs(idx + row + j + c);
  }
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = nan;
    gather(v[c], source<kAxis>(x, i, j + c, t[c], n),
           t[c] >= 0 && t[c] < bound);
  }
  __stcs(reinterpret_cast<float4*>(out + row + j),
         make_float4(v[0], v[1], v[2], v[3]));
}

}  // namespace

// out = take_along_axis(x, idx, axis) (see above); m, n >= 1, axis 0 or 1;
// x, idx and out aligned to their element size.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int gll_take_along_f32(const void* x, const void* idx, void* out,
                                  int m, int n, int axis, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // out's and idx's offsets from a 16-byte boundary, in elements
  const int out_off = (int)((reinterpret_cast<uintptr_t>(out) / 4) % 4);
  const int idx_off = (int)((reinterpret_cast<uintptr_t>(idx) / 8) % 2);
  const int idx_vec = (out_off - idx_off) % 2 == 0;
  // a slab's width in units: a power of two up to 32 that covers a row's
  // units when it can, and along axis 0 at most kSlabElems / m columns
  const int units = n / 4 > 0 ? n / 4 : 1;
  int tx = 1;
  while (tx < 32 && tx < units) tx *= 2;
  if (axis == 0)
    while (tx > 1 && 4LL * tx * m > kSlabElems) tx /= 2;
  const int ty = kThreads / tx;
  const long long bands = ((long long)m + ty - 1) / ty;
  const long long slabs = (units + tx - 1) / tx;
  const dim3 grid((unsigned)(bands * slabs)), block(tx, ty);
  if (axis == 0) {
    take_along_kernel<0><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const long long*>(idx),
        static_cast<float*>(out), m, n, out_off, idx_vec, (unsigned)bands);
  } else {
    take_along_kernel<1><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const long long*>(idx),
        static_cast<float*>(out), m, n, out_off, idx_vec, (unsigned)bands);
  }
  return static_cast<int>(cudaGetLastError());
}
