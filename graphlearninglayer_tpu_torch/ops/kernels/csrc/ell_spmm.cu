// Kernel P3: the slot sum of the symmetric-ELL matvec, a gather SpMM.
//
//   out[i, c] = sum_s val[i, s] * x[nbr[i, s], c]
//
// nbr (m, S) int64 and val (m, S) float32 row-major (the port's SymEll
// layout, ops/graph.py), x (n, l) float32 row-major, out (m, l) float32.
// Every entry of nbr must lie in [0, n); the kernel does not check them.
//
// It replaces the Pallas TPU probe benchmarks/probe_pallas_gather.py:47
// (make_lane_gather.run), whose body acc[c, i] += val[s, i] * x_t[c,
// nbr[s, i]] is this sum over a slot-major (S, n) layout and a (128, n)
// table resident in VMEM.  Here the layout stays row-major and x stays in
// device memory: at the eval's size (n = 60,250, l = 10 or 100) the (n, l)
// iterate is 2.4-24 MB and stays in the H100's 50 MB L2 between matvecs.
//
// Bound.  The kernel must read val once, m S 4 bytes, and nbr only on the
// slots in use (val != 0), 8 bytes each, and write out once, m l 4 bytes;
// x adds n l 4 bytes once when it is not already in L2.  A slot whose
// value is 0 (the padding after each row's edges, and masked edges)
// contributes nothing, so its index is never needed.  It does 2 l float32
// operations a used slot, far below the 67 TFLOP/s rate, so the bound is
// bytes: on the eval's graph (m = n = 60,250, S = 562 slots of which 17%
// are in use, l = 10) about 56 us at 3.35 TB/s.  Beyond the bound, every
// used slot gathers one row of x (40 bytes at l = 10: up to two 32-byte
// sectors) from L2, several times the 12 bytes of the slot's index and
// value: the L2's rate, not the memory's, may set the pace.
//
// Design.  One warp a row, 8 rows a 256-thread block.  The warp takes the
// row's slots 32 at a time: each lane loads one slot's value (one
// coalesced 128-byte load), a ballot marks the slots in use (value not
// 0), and only their lanes load the index and pack (value, index) into
// the warp's shared-memory list; 32 padding slots cost their values and
// one ballot.  The warp's 32 lanes form G = 32 / LPG groups of LPG lanes;
// group g takes the list's entries g, g + G, ..., and within a group lane
// j gathers classes j, j + LPG, ..., (CPL of them, in registers) of the
// entry's row of x, consecutive lanes on consecutive addresses.  The
// groups' partial sums are then added with warp shuffles and group 0
// writes the row.  Classes beyond LPG CPL are taken in further passes
// over the row's slots, so any l is right; the choice of (LPG, CPL) below
// keeps l <= 12 (4 x 3) and l <= 128 (32 x 4) to one pass.  Each output
// element is written by one lane, without atomics, and the sum's order is
// fixed, so the result is deterministic; it is not torch.sum's order.
// Skipping the zero slots also means a padding slot never carries a
// non-finite x[0] into the row, as the plain version's 0 * x[0] would.
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;

template <int LPG, int CPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ell_gather_spmm_kernel(const long long* __restrict__ nbr,
                       const float* __restrict__ val,
                       const float* __restrict__ x, float* __restrict__ out,
                       int m, int s_slots, int l) {
  constexpr int G = 32 / LPG;     // slot groups a warp
  constexpr int CB = LPG * CPL;   // classes a pass
  // each warp's used slots of the current 32, packed: (value, column)
  __shared__ float used_val[kRowsPerBlock][32];
  __shared__ long long used_col[kRowsPerBlock][32];
  const int w = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + w;
  if (row >= m) return;           // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = lane / LPG, j = lane % LPG;
  const unsigned below = (1u << lane) - 1u;
  const long long* nrow = nbr + row * s_slots;
  const float* vrow = val + row * s_slots;
  for (int c0 = 0; c0 < l; c0 += CB) {
    float acc[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[t] = 0.0f;
    for (int s0 = 0; s0 < s_slots; s0 += 32) {
      const int s = s0 + lane;
      const float v = s < s_slots ? __ldg(vrow + s) : 0.0f;
      const unsigned used = __ballot_sync(0xffffffffu, v != 0.0f);
      if (used == 0u) continue;   // warp-uniform: 32 padding slots
      if (v != 0.0f) {
        const int r = __popc(used & below);
        used_val[w][r] = v;
        used_col[w][r] = __ldg(nrow + s);
      }
      __syncwarp();
      const int cnt = __popc(used);
      for (int u = g; u < cnt; u += G) {
        const float uv = used_val[w][u];
        const float* xr = x + used_col[w][u] * l + c0 + j;
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          if (c0 + j + t * LPG < l)
            acc[t] = fmaf(uv, __ldg(xr + t * LPG), acc[t]);
        }
      }
      __syncwarp();               // read before the next 32 overwrite
    }
#pragma unroll
    for (int off = LPG; off < 32; off <<= 1) {
#pragma unroll
      for (int t = 0; t < CPL; ++t)
        acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
    }
    if (g == 0) {
      float* orow = out + row * l + c0 + j;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        if (c0 + j + t * LPG < l) orow[t * LPG] = acc[t];
      }
    }
  }
}

template <int LPG, int CPL>
void launch(const void* nbr, const void* val, const void* x, void* out,
            int m, int s_slots, int l, cudaStream_t stream) {
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  ell_gather_spmm_kernel<LPG, CPL>
      <<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const long long*>(nbr), static_cast<const float*>(val),
      static_cast<const float*>(x), static_cast<float*>(out), m, s_slots, l);
}

}  // namespace

// out = the slot sum above; m >= 1, s_slots >= 0, l >= 1.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int gll_ell_gather_spmm_f32(const void* nbr, const void* val,
                                       const void* x, void* out, int m,
                                       int s_slots, int l, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l <= 4) {
    launch<4, 1>(nbr, val, x, out, m, s_slots, l, st);
  } else if (l <= 12) {
    launch<4, 3>(nbr, val, x, out, m, s_slots, l, st);
  } else {
    launch<32, 4>(nbr, val, x, out, m, s_slots, l, st);
  }
  return static_cast<int>(cudaGetLastError());
}
