// Kernel P3: the slot sum of the symmetric-ELL matvec, a gather SpMM.
//
//   out[i, c] = sum_{s < count[i]} val[i, s] * x[nbr[i, s], c]
//
// nbr (m, S) int64 and val (m, S) float32 row-major (the port's SymEll
// layout, ops/graph.py), count (m,) int32 or null (then every row counts S
// slots), x (n, l) float32 row-major, out (m, l) float32.  Every entry of
// nbr below its row's count must lie in [0, n); the kernel does not check
// them.  SymEll packs each row's slots to the front (its k out-edges, then
// its in-edges) and records their number, k + min(in-degree, cap), so the
// slots past it are padding and the sum over [0, count) is the full one.
//
// It replaces the Pallas TPU probe benchmarks/probe_pallas_gather.py:47
// (make_lane_gather.run), whose body acc[c, i] += val[s, i] * x_t[c,
// nbr[s, i]] is this sum over a slot-major (S, n) layout and a (128, n)
// table resident in VMEM.  Here the layout stays row-major and x stays in
// device memory: at the eval's size (n = 60,250, l = 10 or 100) the (n, l)
// iterate is 2.4-24 MB and stays in the H100's 50 MB L2 between matvecs.
//
// Bound.  The kernel must read val and nbr on the counted slots, 12 bytes
// each, and the counts, 4 bytes a row, read x once, n l 4 bytes, and write
// out once, m l 4 bytes.  It does 2 l float32 operations a used slot, far
// below the 67 TFLOP/s rate, so the bound is bytes: on the eval's graph
// (m = n = 60,250, 98 counted slots a row of S = 562, l = 10) about 23 us
// at 3.35 TB/s.  Beyond the bound, every used slot gathers one row of x
// from L2 (40 bytes at l = 10: two 32-byte sectors at most; 400 bytes at
// l = 100: 13 sectors or more), several times the slot's 12 bytes: at
// l = 100 the L2's rate, not the memory's, may set the pace.
//
// Design.  One warp a row, 8 rows a 256-thread block.  The warp reads the
// row's count and takes its slots 32 at a time, a lane a slot: value and
// index in two independent loads (no load waits on another), the next 32
// loaded while the current 32 are summed.  Padding past the count is never
// read.  x's rows are read as W-float vectors (float4 where l % 4 == 0 and
// x is 16-byte aligned, float2 where l % 2 == 0, else float): the warp's 32
// lanes form G = 32 / LPG groups of LPG lanes, group g takes slots g,
// g + G, ... of the 32 (a slot's value and index come by shuffle), and
// lane j of a group gathers vectors j, j + LPG, ... (CPL of them) of the
// slot's row of x, consecutive lanes on consecutive addresses.  U slots a
// group are in flight at once (all their loads issued before the first
// add), so a warp has G U rows of x in flight: 4 at l = 100 (25 float4
// lanes each), 16 at l = 10 (5 float2 lanes in groups of 8), 32 at l = 1
// or 4.  A slot whose value is 0 (a masked edge) loads nothing, so a
// non-finite row of x that only such slots point at never reaches out.
// The groups' partial sums are added with warp shuffles and group 0 writes
// the row.  Vectors beyond LPG CPL take further passes over the row's
// slots, so any l is right.  Each output element is written by one lane,
// without atomics, and the sum's order is fixed, so the result is
// deterministic; it is not torch.sum's order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma_into(float& acc, float v, float x) {
  acc = fmaf(v, x, acc);
}
__device__ __forceinline__ void fma_into(float2& acc, float v, float2 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
}
__device__ __forceinline__ void fma_into(float4& acc, float v, float4 x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

__device__ __forceinline__ void add_shfl(float& a, int off) {
  a += __shfl_xor_sync(kFull, a, off);
}
__device__ __forceinline__ void add_shfl(float2& a, int off) {
  a.x += __shfl_xor_sync(kFull, a.x, off);
  a.y += __shfl_xor_sync(kFull, a.y, off);
}
__device__ __forceinline__ void add_shfl(float4& a, int off) {
  a.x += __shfl_xor_sync(kFull, a.x, off);
  a.y += __shfl_xor_sync(kFull, a.y, off);
  a.z += __shfl_xor_sync(kFull, a.z, off);
  a.w += __shfl_xor_sync(kFull, a.w, off);
}

// A slot's value and column, 0 past the count: two independent loads.
__device__ __forceinline__ void load_slot(const long long* __restrict__ nrow,
                                          const float* __restrict__ vrow,
                                          int s, int count, float& v,
                                          int& col) {
  v = 0.f;
  col = 0;
  if (s < count) {
    v = __ldg(vrow + s);
    col = static_cast<int>(__ldg(nrow + s));
  }
}

template <typename V, int LPG, int CPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ell_gather_spmm_kernel(const long long* __restrict__ nbr,
                       const float* __restrict__ val,
                       const int* __restrict__ counts,
                       const float* __restrict__ x, float* __restrict__ out,
                       int m, int s_slots, int l) {
  constexpr int G = 32 / LPG;            // slot groups a warp
  constexpr int U = LPG < 4 ? LPG : 4;   // slots a group has in flight
  constexpr int STEP = G * U;            // slots a step, divides 32
  constexpr int CB = LPG * CPL;          // vectors a pass
  constexpr int W = sizeof(V) / sizeof(float);
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;                  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = lane / LPG, j = lane % LPG;
  const int nv = l / W;                  // vectors a row of x
  const long long* nrow = nbr + row * s_slots;
  const float* vrow = val + row * s_slots;
  const V* xv = reinterpret_cast<const V*>(x);
  int count = s_slots;
  if (counts != nullptr) count = min(__ldg(counts + row), s_slots);
  for (int c0 = 0; c0 < nv; c0 += CB) {
    V acc[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[t] = zero<V>();
    float v_cur, v_next;
    int col_cur, col_next;
    load_slot(nrow, vrow, lane, count, v_cur, col_cur);
    for (int s0 = 0; s0 < count; s0 += 32) {
      load_slot(nrow, vrow, s0 + 32 + lane, count, v_next, col_next);
      const int here = min(32, count - s0);
      for (int u = 0; u < here; u += STEP) {
        float sv[U];
        V xr[U][CPL];
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int slot = u + q * G + g;
          sv[q] = __shfl_sync(kFull, v_cur, slot);
          const int sc = __shfl_sync(kFull, col_cur, slot);
          const V* xrow = xv + (size_t)sc * nv + c0 + j;
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            xr[q][t] = (sv[q] != 0.f && c0 + j + t * LPG < nv)
                           ? __ldg(xrow + t * LPG)
                           : zero<V>();
          }
        }
#pragma unroll
        for (int q = 0; q < U; ++q) {
#pragma unroll
          for (int t = 0; t < CPL; ++t) fma_into(acc[t], sv[q], xr[q][t]);
        }
      }
      v_cur = v_next;
      col_cur = col_next;
    }
#pragma unroll
    for (int off = LPG; off < 32; off <<= 1) {
#pragma unroll
      for (int t = 0; t < CPL; ++t) add_shfl(acc[t], off);
    }
    if (g == 0) {
      V* orow = reinterpret_cast<V*>(out + row * l) + c0 + j;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        if (c0 + j + t * LPG < nv) orow[t * LPG] = acc[t];
      }
    }
  }
}

template <typename V, int LPG, int CPL>
int launch(const void* nbr, const void* val, const void* counts,
           const void* x, void* out, int m, int s_slots, int l,
           cudaStream_t stream) {
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  ell_gather_spmm_kernel<V, LPG, CPL>
      <<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const long long*>(nbr), static_cast<const float*>(val),
      static_cast<const int*>(counts), static_cast<const float*>(x),
      static_cast<float*>(out), m, s_slots, l);
  return static_cast<int>(cudaGetLastError());
}

// The lane layout for nv vectors a row: the fewest lanes a group (a power
// of two) that hold one vector each, up to 32; past 32 vectors, CPL of them
// a lane (at most 4, then further passes).
template <typename V>
int launch_for(int nv, const void* nbr, const void* val, const void* counts,
               const void* x, void* out, int m, int s, int l,
               cudaStream_t st) {
  if (nv <= 1) return launch<V, 1, 1>(nbr, val, counts, x, out, m, s, l, st);
  if (nv <= 2) return launch<V, 2, 1>(nbr, val, counts, x, out, m, s, l, st);
  if (nv <= 4) return launch<V, 4, 1>(nbr, val, counts, x, out, m, s, l, st);
  if (nv <= 8) return launch<V, 8, 1>(nbr, val, counts, x, out, m, s, l, st);
  if (nv <= 16) {
    return launch<V, 16, 1>(nbr, val, counts, x, out, m, s, l, st);
  }
  if (nv <= 32) {
    return launch<V, 32, 1>(nbr, val, counts, x, out, m, s, l, st);
  }
  if (nv <= 64) {
    return launch<V, 32, 2>(nbr, val, counts, x, out, m, s, l, st);
  }
  if (nv <= 96) {
    return launch<V, 32, 3>(nbr, val, counts, x, out, m, s, l, st);
  }
  return launch<V, 32, 4>(nbr, val, counts, x, out, m, s, l, st);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// out = the slot sum above; m >= 1, s_slots >= 0, l >= 1; counts may be
// null.  Returns the launch's cudaError_t (0 on success).
extern "C" int gll_ell_gather_spmm_f32(const void* nbr, const void* val,
                                       const void* counts, const void* x,
                                       void* out, int m, int s_slots, int l,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l % 4 == 0 && aligned(x, 16) && aligned(out, 16)) {
    return launch_for<float4>(l / 4, nbr, val, counts, x, out, m, s_slots, l,
                              st);
  }
  if (l % 2 == 0 && aligned(x, 8) && aligned(out, 8)) {
    return launch_for<float2>(l / 2, nbr, val, counts, x, out, m, s_slots, l,
                              st);
  }
  return launch_for<float>(l, nbr, val, counts, x, out, m, s_slots, l, st);
}
