// K1: fused squared distance + union-symmetrized masked affinity.
//
// Replaces the Pallas TPU kernel
//   graphlearninglayer_tpu/ops/kernels/affinity.py::fused_affinity_sym
//   (kernel body _affinity_sym_kernel).
// It computes, for x (n, d) f32, eps (n,) f32 and the raw directed KNN
// indicator M (n, n) f32 in {0, 1}:
//   d2[i,j] = max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0)
//   W[i,j]  = exp(-4 d2[i,j] / (eps_i eps_j)) * max(M[i,j], M[j,i])
//             * [i != j] * [d2[i,j] > 0]
// No n x n distance matrix and no symmetrized mask is written to device
// memory: the only n x n traffic is reading M and writing W.
//
// Bound on an H100 SXM at the training op's shape (n = 1500, d = 128):
//   bytes:      M read once (9.0 MB) + W written (9.0 MB) + x and eps
//               (0.8 MB) = 18.8 MB; at 3.35 TB/s that is 5.6 us (the
//               transposed read of M re-reads the same 9 MB, mostly from L2);
//   operations: W is symmetric, so the function needs only the upper
//               triangle of the Gram matrix, n (n + 1) d = 0.29 GFLOP of f32
//               FMA work; at the 67 TFLOP/s non-tensor f32 rate that is
//               4.3 us.
// So the function is bound by bytes.  This kernel forms every tile, both
// triangles, so it does twice the needed dot-product work.
//
// Design: one block of 32 x 8 threads owns one 32 x 32 output tile; each
// thread owns four of its entries (one column, four rows).  The block stages
// a 32-wide slice of the x row tile and of the x column tile in shared
// memory and accumulates the dot products in f32 FMA (no TF32, no tensor
// cores, so the distances match a full-f32 reference).  The row norms are
// summed from the same staged slices.  M[i-tile, j-tile] is read directly,
// coalesced; M[j-tile, i-tile] is staged through shared memory so that its
// transposed read is coalesced too.  Rows and columns past n are masked in
// the kernel, so no padding is needed.  The inner loop issues five
// shared-memory loads per four FMAs, so it is limited by shared-memory
// bandwidth well below the FMA peak; register tiling is the next step.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;             // output tile edge
constexpr int kRows = 8;              // blockDim.y
constexpr int kPer = kTile / kRows;   // rows of the tile per thread

__global__ void __launch_bounds__(kTile * kRows)
affinity_sym_kernel(const float* __restrict__ x, const float* __restrict__ eps,
                    const float* __restrict__ m_raw, float* __restrict__ w,
                    int n, int d) {
  __shared__ float xi[kTile][kTile + 1];  // x[i-tile, k-slice]
  __shared__ float xj[kTile][kTile + 1];  // x[j-tile, k-slice]
  __shared__ float mt[kTile][kTile + 1];  // M[j-tile, i-tile]
  __shared__ float sqi[kTile];
  __shared__ float sqj[kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  float sq = 0.f;  // warp ty == 0: |x_{i0+tx}|^2, warp ty == 1: |x_{j0+tx}|^2

  for (int k0 = 0; k0 < d; k0 += kTile) {
    const int k = k0 + tx;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int row = ty + r * kRows;
      const int gi = i0 + row;
      const int gj = j0 + row;
      xi[row][tx] = (gi < n && k < d) ? x[(size_t)gi * d + k] : 0.f;
      xj[row][tx] = (gj < n && k < d) ? x[(size_t)gj * d + k] : 0.f;
    }
    __syncthreads();
    if (ty == 0) {
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) sq = fmaf(xi[tx][kk], xi[tx][kk], sq);
    } else if (ty == 1) {
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) sq = fmaf(xj[tx][kk], xj[tx][kk], sq);
    }
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float b = xj[tx][kk];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        acc[r] = fmaf(xi[ty + r * kRows][kk], b, acc[r]);
      }
    }
    __syncthreads();
  }

  if (ty == 0) {
    sqi[tx] = sq;
  } else if (ty == 1) {
    sqj[tx] = sq;
  }
  // stage M[j-tile, i-tile] with coalesced reads along its rows
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int row = ty + r * kRows;
    const int gj = j0 + row;
    const int gi = i0 + tx;
    mt[row][tx] = (gj < n && gi < n) ? m_raw[(size_t)gj * n + gi] : 0.f;
  }
  __syncthreads();

  const int j = j0 + tx;
  if (j >= n) return;
  const float eps_j = eps[j];
  const float sq_j = sqj[tx];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int row = ty + r * kRows;
    const int i = i0 + row;
    if (i >= n) break;
    const float d2 = fmaxf(sqi[row] + sq_j - 2.f * acc[r], 0.f);
    const float mask = fmaxf(m_raw[(size_t)i * n + j], mt[tx][row]);
    const float inv = 1.f / (eps[i] * eps_j);
    w[(size_t)i * n + j] =
        (i != j && d2 > 0.f) ? expf(-4.f * d2 * inv) * mask : 0.f;
  }
}

}  // namespace

// Launches K1 on ``stream``; all pointers are device pointers to contiguous
// f32 arrays: x (n, d), eps (n,), m_raw (n, n), w (n, n).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int gll_affinity_sym_f32(const float* x, const float* eps,
                                    const float* m_raw, float* w, int n,
                                    int d, void* stream) {
  const dim3 block(kTile, kRows);
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  affinity_sym_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, eps, m_raw, w, n, d);
  return static_cast<int>(cudaGetLastError());
}
