// K2: exact fused KNN: all-pairs squared distance + running top-k per row.
//
// Replaces the Pallas TPU kernel
//   graphlearninglayer_tpu/ops/kernels/knn_topk.py::fused_knn
//   (kernel body _make_kernel, with its bitonic roll network).
// For x (n, d) f32 it returns, for every row i, the k (<= 64) smallest
//   d2[i,j] = max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0)
// in ascending order, with self pinned first (d2[i,i] := -1 during
// selection), as nbr (n, k) int64 and dist2 (n, k) f32 clamped at 0.  No
// distance panel is written to device memory.
//
// Bound on an H100 SXM at the transductive eval's shape (n = 60,250,
// d = 128, k = 50):
//   operations: d2 is symmetric, so the function needs one triangle of
//               the Gram matrix, n (n + 1) / 2 d = 2.3e11 f32 FMA (0.46
//               TFLOP counting an FMA as two); at the 67 TFLOP/s
//               non-tensor f32 rate that is 6.9 ms;
//   bytes:      x read once (31 MB) + nbr and dist2 written (36 MB) = 67 MB,
//               20 us at 3.35 TB/s.
// So the function is bound by operations, by a factor of ~700.
//
// Design: one block of 256 threads owns 64 query rows and streams all
// column tiles of 64 candidates.  Per column tile:
//   1. the Gram tile is formed in registers, 4 x 4 outputs a thread, from
//      32-wide feature slices of the query and candidate rows staged,
//      transposed, in shared memory (stride 68: the float4 reads are
//      aligned, and the transposing stores hit 32 distinct banks).  Plain
//      f32 FMA: no TF32, no tensor cores.  The slices past d are zero, so
//      any d works without padding copies;
//   2. the d2 tile (self := -1, columns past n := +inf) goes to shared
//      memory over the slices' buffer;
//   3. warp w keeps the running lists of 8 rows in registers: a sorted
//      list of 64 (distance, index) pairs per row, two per lane.  The k-th
//      entry is the row's threshold.  A tile's 64 candidates are tested
//      against it with one compare and two ballots; each survivor (in
//      column order, so ties keep the lower index) is inserted by the warp
//      in one step: its position is the popcount of a ballot, and the
//      shift is a __shfl_up_sync.  Expected insertions per row are about
//      k (1 + ln(n / k)), ~400 at the eval's shape, against 60k tests.
// Row norms come from a first small kernel (one warp per row).
//
// What holds it back: the Gram tile runs at the shared-memory rate of two
// float4 loads per 16 FMA, selection is serial per row within a warp, and
// both triangles are formed, twice the operations of the bound.  A larger register tile (8 x 8), a
// cp.async pipeline and forming one triangle with both rows' lists updated
// are the next steps.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                  // query rows per block
constexpr int kBN = 64;                  // candidates per column tile
constexpr int kDK = 32;                  // feature slice per stage
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBM / kWarps;  // 8
constexpr int kStride = kBM + 4;         // staged slice row stride (floats)
constexpr int kD2Stride = kBN + 4;       // d2 tile row stride (floats)
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBM == kBN, "the loader maps query and candidate tiles alike");
static_assert(2 * kDK * kStride >= kBM * kD2Stride,
              "the d2 tile reuses the staged slices' buffer");

__global__ void sqnorm_kernel(const float* __restrict__ x,
                              float* __restrict__ sq, int n, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = x + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(xr[c], xr[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) sq[row] = s;
}

// Stage x[r0 : r0 + 64, c0 : c0 + 32] transposed into dst[c][r] (stride
// kStride), zero past n rows or d columns.  A warp covers 4 rows x 8
// consecutive columns per pass: 32-byte global segments, and the stores
// land on 32 distinct banks.
__device__ __forceinline__ void stage_slice(const float* __restrict__ x,
                                            float* dst, int r0, int c0,
                                            int n, int d, int warp,
                                            int lane) {
#pragma unroll
  for (int p = 0; p < (kBM * kDK) / kThreads; ++p) {
    const int combo = p * kWarps + warp;          // 0 .. 63
    const int m = (combo & 15) * 4 + (lane & 3);  // row in the tile
    const int c = (combo >> 4) * 8 + (lane >> 2); // column in the slice
    const int gr = r0 + m;
    const int gc = c0 + c;
    dst[c * kStride + m] =
        (gr < n && gc < d) ? __ldg(x + (size_t)gr * d + gc) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
knn_topk_kernel(const float* __restrict__ x, const float* __restrict__ sq,
                int64_t* __restrict__ nbr, float* __restrict__ dist2, int n,
                int d, int k) {
  __shared__ __align__(16) float smem[2 * kDK * kStride];
  float* as = smem;                  // query slice, [c][row]
  float* bs = smem + kDK * kStride;  // candidate slice, [c][col]
  float* d2t = smem;                 // d2 tile, [row][col], after the slices

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tx = t & 15;  // output columns 4 tx .. 4 tx + 3
  const int ty = t >> 4;  // output rows 4 ty .. 4 ty + 3
  const int r0 = blockIdx.x * kBM;

  float sqi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = r0 + ty * 4 + i;
    sqi[i] = gi < n ? sq[gi] : 0.f;
  }

  // running sorted lists: row r0 + warp * 8 + r, positions lane and lane + 32
  float lv[kRowsPerWarp][2];
  int li[kRowsPerWarp][2];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    lv[r][0] = lv[r][1] = INFINITY;
    li[r][0] = li[r][1] = 0;
  }
  const int thr_lane = (k - 1) & 31;
  const bool thr_hi = k > 32;

  for (int c0 = 0; c0 < n; c0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int f0 = 0; f0 < d; f0 += kDK) {
      __syncthreads();  // earlier readers of the buffer are done
      stage_slice(x, as, r0, f0, n, d, warp, lane);
      stage_slice(x, bs, c0, f0, n, d, warp, lane);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(as + c * kStride +
                                                          ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(bs + c * kStride +
                                                          tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
      }
    }

    float sqj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = c0 + tx * 4 + j;
      sqj[j] = gj < n ? sq[gj] : 0.f;
    }
    __syncthreads();  // all reads of the slices are done: reuse as d2 tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = r0 + ty * 4 + i;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gj = c0 + tx * 4 + j;
        float e = fmaxf(sqi[i] + sqj[j] - 2.f * acc[i][j], 0.f);
        e = gi == gj ? -1.f : e;
        v[j] = gj < n ? e : INFINITY;
      }
      *reinterpret_cast<float4*>(d2t + (ty * 4 + i) * kD2Stride + tx * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp * kRowsPerWarp + r;
      if (r0 + lr >= n) break;  // warp-uniform
      const float* row = d2t + lr * kD2Stride;
      const float cand[2] = {row[lane], row[lane + 32]};
      const float thr =
          __shfl_sync(kFull, thr_hi ? lv[r][1] : lv[r][0], thr_lane);
      unsigned pass[2] = {__ballot_sync(kFull, cand[0] < thr),
                          __ballot_sync(kFull, cand[1] < thr)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        while (pass[h]) {
          const int src = __ffs(pass[h]) - 1;
          pass[h] &= pass[h] - 1;
          const float v = __shfl_sync(kFull, cand[h], src);
          const int vi = c0 + h * 32 + src;
          float a0 = lv[r][0], a1 = lv[r][1];
          int b0 = li[r][0], b1 = li[r][1];
          // insertion position = number of entries <= v (the list is sorted)
          const int pos = __popc(__ballot_sync(kFull, a0 <= v)) +
                          __popc(__ballot_sync(kFull, a1 <= v));
          if (pos >= k) continue;  // warp-uniform: beaten meanwhile
          float p0 = __shfl_up_sync(kFull, a0, 1);
          float p1 = __shfl_up_sync(kFull, a1, 1);
          const float w = __shfl_sync(kFull, a0, 31);
          int q0 = __shfl_up_sync(kFull, b0, 1);
          int q1 = __shfl_up_sync(kFull, b1, 1);
          const int wi = __shfl_sync(kFull, b0, 31);
          if (lane == 0) {  // position 31 moves to position 32
            p1 = w;
            q1 = wi;
          }
          if (lane > pos) {
            a0 = p0;
            b0 = q0;
          } else if (lane == pos) {
            a0 = v;
            b0 = vi;
          }
          if (lane + 32 > pos) {
            a1 = p1;
            b1 = q1;
          } else if (lane + 32 == pos) {
            a1 = v;
            b1 = vi;
          }
          lv[r][0] = a0;
          lv[r][1] = a1;
          li[r][0] = b0;
          li[r][1] = b1;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int gr = r0 + warp * kRowsPerWarp + r;
    if (gr >= n) break;
    const size_t o = (size_t)gr * k;
    if (lane < k) {
      nbr[o + lane] = li[r][0];
      dist2[o + lane] = fmaxf(lv[r][0], 0.f);
    }
    if (lane + 32 < k) {
      nbr[o + lane + 32] = li[r][1];
      dist2[o + lane + 32] = fmaxf(lv[r][1], 0.f);
    }
  }
}

}  // namespace

// Launches K2 on ``stream``.  Device pointers to contiguous arrays: x (n, d)
// f32, sq (n,) f32 scratch for the row norms, nbr (n, k) int64 and dist2
// (n, k) f32 outputs.  Requires 1 <= k <= min(64, n).  Returns the CUDA
// error code of the launches (0 on success).
extern "C" int gll_knn_topk_f32(const float* x, float* sq, int64_t* nbr,
                                float* dist2, int n, int d, int k,
                                void* stream) {
  if (n < 1 || d < 1 || k < 1 || k > 64 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = kThreads / 32;
  sqnorm_kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
      x, sq, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_topk_kernel<<<(n + kBM - 1) / kBM, kThreads, 0, s>>>(x, sq, nbr, dist2,
                                                           n, d, k);
  return static_cast<int>(cudaGetLastError());
}
