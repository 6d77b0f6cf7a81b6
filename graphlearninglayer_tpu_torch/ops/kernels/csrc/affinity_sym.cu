// K1: fused squared distance + union-symmetrized masked affinity, and its
// sibling K3: fused squared distance + affinity times a precomputed mask.
//
// K1 replaces the Pallas TPU kernel
//   graphlearninglayer_tpu/ops/kernels/affinity.py::fused_affinity_sym
//   (kernel body _affinity_sym_kernel).
// It computes, for x (n, d) f32, eps (n,) f32 and the raw directed KNN
// indicator M (n, n) f32 in {0, 1}:
//   W[i,j]  = exp(-4 d2[i,j] / (eps_i eps_j)) * max(M[i,j], M[j,i])
//             * [i != j] * [d2[i,j] > 0]
//   d2[i,j] = sum_f (x_i,f - x_j,f)^2   on the kept entries, those where
//             max(M[i,j], M[j,i]) != 0 and i != j (W is 0 elsewhere),
// the d2 rule of every KNN route of the port: a coincident pair is at
// exactly 0 and dropped, where |x_i|^2 + |x_j|^2 - 2 <x_i, x_j> can leave
// a rounding residue.
// K3 replaces
//   graphlearninglayer_tpu/ops/kernels/affinity.py::fused_affinity
//   (kernel body _affinity_kernel):
//   W[i,j]  = exp(-4 d2[i,j] / (eps_i eps_j)) * M[i,j],
//   d2[i,j] = max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0)
// with no symmetrization and no self or zero-distance exclusion, as the
// JAX kernel has it.  They share the tile order, the copies of M and the
// stores of W.
// No n x n distance matrix and no symmetrized mask is written to device
// memory: the only n x n traffic is reading M and writing W.
//
// Bound on an H100 SXM at the training op's shape (n = 1500, d = 128):
//   bytes:      M read once (9.0 MB) + W written (9.0 MB) + x and eps
//               (0.8 MB) = 18.8 MB; at 3.35 TB/s that is 5.6 us;
//   operations: K3 needs the upper triangle of the Gram matrix, n (n + 1) d
//               = 0.29 GFLOP of f32 FMA work, 4.3 us at the 67 TFLOP/s
//               non-tensor f32 rate; K1 only its kept entries' differences,
//               3 d operations each (at most 2 k n of them, 0.03 GFLOP).
// So both are bound by bytes.
//
// K1's design: one block of 128 threads per pair of 48-row tiles (bi <= bj)
// of the upper triangle, as K3's below, copies both M tiles with cp.async,
// and turns each entry into max(M[i, j], M[j, i]) or 0 in place.  The kept
// entries (i != j and that union not 0: about 2k / n of a tile, 77 of a
// 48 x 48 tile at n = 1500, k = 25) are queued in shared memory, and
// groups of kDiffLanes lanes form each one's d2 from the two rows of x,
// read from L2, kDiffEntries entries a group at once: a lane sums its
// features' squared differences as one fmaf chain and the group adds its
// lanes in a fixed butterfly, so W is deterministic and, since
// (a - b)^2 = (b - a)^2, exactly symmetric.  No
// Gram tile is formed: W is 0 off the kept entries whatever their distance.
// 25 KB of shared memory a block; four blocks an SM (128 registers a
// thread, for the kept entries' loads in flight).
//
// K3's design (Hopper, plain f32 FMA: no TF32, no tensor cores, so the
// distances match a full-f32 reference):
//   1. One block of 128 threads per pair of 48-row tiles (bi <= bj) of the
//      upper triangle: at n = 1500, 32 tile rows and 528 blocks, four an SM
//      (48.4 KB of shared memory and 128 registers a thread), so one even
//      wave on 132 SMs.  (64-row tiles, 300 blocks at three an SM, leave 36
//      SMs with a third block and ran slower on the card.)  The block forms
//      the Gram tile <x_i, x_j> once and writes W[i-tile, j-tile] and, off
//      the diagonal, W[j-tile, i-tile]; a diagonal tile is written once.
//      The two halves take mask[i, j] and mask[j, i] times the one
//      symmetric exp(-4 d2 / (eps_i eps_j)).
//   2. 32-feature slices of both x tiles stream through a cp.async double
//      buffer, row-major with rows padded to 36 floats.  Two groups of 64
//      threads split each slice's features 16 / 16; a thread keeps a 6 x 6
//      register tile (rows ty + 8 r, columns tx + 8 c) and reads its rows'
//      and columns' features as float2, the next pair loaded under the
//      current pair's FMA.  At the end the groups sum their partial tiles
//      through shared memory.  The row norms come from the same slices, one
//      thread a row, as two fmaf chains in the groups' feature order summed
//      the same way, so two identical rows give d2 = 0 exactly.
//   3. The copies of M[i-tile, j-tile] and M[j-tile, i-tile] ride in the
//      slices' cp.async groups, a share with each slice, so they land while
//      the Gram loop runs.  After it, each thread turns its 18 entries of
//      both M tiles into W in place in shared memory (the transposed entry
//      is the same thread's), with 1 / eps precomputed a row, and the block
//      stores both tiles row by row as float4, coalesced.
//   4. Any n and d, no host padding (K1 too): the copies zero-fill rows and features
//      past n and d; 16-byte copies of x need d % 4 == 0, those of M and the
//      float4 stores of W n % 4 == 0 and 16-byte alignment, else the kernel
//      takes 4-byte copies and scalar stores.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, k1_turns.py;
// PERF.md): see PERF.md for K1's and K3's times against the bound and
// against the previous designs (K1 with K3's Gram tile; 32 x 32 tiles, both
// triangles, 4 outputs a thread, scalar shared loads).  What still holds
// K3 back: every block re-reads both x tiles from L2 (26 MB of copies at
// n = 1500, against 9 MB each of M and W), and issuing the copies, the
// epilogue and the stores sit beside the FMA loop rather than under it.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 48;                // output tile edge
constexpr int kSide = 8;                 // a group's threads along an edge
constexpr int kPer = kTile / kSide;      // a thread's rows (and columns): 6
constexpr int kGroups = 2;               // feature halves of a stage
constexpr int kGroupThreads = kSide * kSide;
constexpr int kThreads = kGroups * kGroupThreads;  // 128
constexpr int kDK = 32;                  // features per pipeline stage
constexpr int kHalf = kDK / kGroups;     // a group's features of a stage
constexpr int kXStride = kDK + 4;        // padded row of a staged x slice
constexpr int kMStride = kTile + 4;      // padded row of a staged M/W tile
constexpr int kBlocksPerSM = 4;
constexpr int kDiffLanes = 8;            // lanes a kept entry's d2 pass
constexpr int kDiffEntries = 4;          // a group's entries in flight

constexpr int kSymBlocksPerSM = 4;

// K3's shared memory in floats, in the order of its carve-up: two stages of
// the x slices of both tiles (the i-tile's rows, then the j-tile's), the
// two M tiles (which become the two W tiles), the norms and the bandwidths
// of both tiles: 48.4 KB.
constexpr int kXFloats = 2 * kTile * kXStride;  // one stage
constexpr int kMFloats = kTile * kMStride;      // one tile
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kXFloats + 2 * kMFloats + 4 * kTile);
// K1's: the two M tiles, the inverse bandwidths of both tiles, the queue of
// kept entries (kTile^2 16-bit positions) and its length: 25.0 KB.
constexpr size_t kSymSmemBytes =
    sizeof(float) * (2 * kMFloats + 2 * kTile) +
    sizeof(unsigned short) * kTile * kTile + 16;

static_assert(kHalf % 4 == 0 && kXStride % 4 == 0 && kMStride % 4 == 0,
              "16-byte aligned rows for cp.async and float4");
static_assert(kThreads >= 2 * kTile, "one thread a staged row's norm");
static_assert(kTile % (kThreads / (kDK / 4)) == 0 &&
                  kTile % (kThreads / kDK) == 0,
              "a thread's x copies stay in one tile or the other");
static_assert(kTile * kMStride <= 2 * kXFloats,
              "the partial tile exchange fits the x buffers");
static_assert(kBlocksPerSM * (kSmemBytes + 1024) <= 228 * 1024,
              "kBlocksPerSM blocks fit an SM's shared memory");
static_assert(kSymBlocksPerSM * (kSymSmemBytes + 1024) <= 228 * 1024,
              "kSymBlocksPerSM blocks fit an SM's shared memory");
static_assert(kTile * kTile <= 65536, "a kept entry's position is 16-bit");
static_assert((kTile * kTile) % kThreads == 0,
              "every lane of a warp takes each step of K1's entry loop");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// First linear block id of tile row r of the upper triangle of t x t tiles.
__device__ __forceinline__ int row_start(int r, int t) {
  return r * t - r * (r - 1) / 2;
}

// Tile pair (bi <= bj) of linear block id b: a float estimate of the row,
// corrected with integer arithmetic.
__device__ __forceinline__ void tile_pair(int b, int t, int& bi, int& bj) {
  const float c = 2.f * t + 1.f;
  int r = static_cast<int>(0.5f * (c - sqrtf(fmaxf(c * c - 8.f * b, 0.f))));
  r = min(max(r, 0), t - 1);
  while (r > 0 && row_start(r, t) > b) --r;
  while (r + 1 < t && row_start(r + 1, t) <= b) ++r;
  bi = r;
  bj = r + (b - row_start(r, t));
}

// Global row of staged row ``row`` (the i-tile's kTile rows, then the
// j-tile's).
__device__ __forceinline__ int tile_row(int row, int i0, int j0) {
  return row < kTile ? i0 + row : j0 + row - kTile;
}

// Stage s's share of the copies of M[i-tile, j-tile] and M[j-tile, i-tile]
// into mij and mji: copies lo .. hi - 1 of this thread's, 16 bytes each
// (kVec) or 4 bytes where n % 4 != 0.
template <bool kVec>
__device__ __forceinline__ void copy_m_share(int s, int stages,
                                             const float* __restrict__ m,
                                             float* mij, float* mji, int i0,
                                             int j0, int n, unsigned tid) {
  constexpr unsigned kPerRow = kVec ? kTile / 4 : kTile;  // copies a row
  constexpr unsigned kAll = 2 * kTile * kPerRow;
  constexpr unsigned kShare = (kAll + kThreads - 1) / kThreads;
  const int lo = s * kShare / stages, hi = (s + 1) * kShare / stages;
  for (int i = lo; i < hi; ++i) {
    const unsigned c = tid + kThreads * unsigned(i);
    if (c >= kAll) break;
    const unsigned t = c / (kTile * kPerRow), rem = c % (kTile * kPerRow);
    const int r = rem / kPerRow, col = (kVec ? 4 : 1) * (rem % kPerRow);
    const int gr = (t == 0 ? i0 : j0) + r, gc = (t == 0 ? j0 : i0) + col;
    float* to = (t == 0 ? mij : mji) + r * kMStride + col;
    const bool ok = gr < n && gc < n;
    const float* from = ok ? m + (size_t)gr * n + gc : m;
    if (kVec) {
      cp_async16(to, from, ok);
    } else {
      cp_async4(to, from, ok);
    }
  }
}

// Copies stage s: features s * kDK .. of both x tiles into buffer s % 2,
// and the stage's share of both M tiles' copies; one cp.async group.  A
// thread's copies are c = tid + kThreads * i, so every index below comes
// from shifts of compile-time constants.
__device__ __forceinline__ void copy_stage(
    int s, int stages, const float* __restrict__ x,
    const float* __restrict__ m, float* xs, float* mij, float* mji, int i0,
    int j0, int n, int d, bool vec_x, bool vec_n, unsigned tid) {
  float* dst = xs + (s & 1) * kXFloats;
  const int k0 = s * kDK;
  if (vec_x) {
    constexpr unsigned kQ = kDK / 4;  // 16-byte copies a staged row
    constexpr unsigned kRowStep = kThreads / kQ;
    const unsigned q = tid % kQ;
#pragma unroll
    for (unsigned i = 0; i < 2 * kTile / kRowStep; ++i) {
      const unsigned row = tid / kQ + kRowStep * i;
      const int g = (i < kTile / kRowStep ? i0 : j0 - kTile) + int(row);
      const int k = k0 + 4 * q;
      const bool ok = g < n && k < d;
      cp_async16(dst + row * kXStride + 4 * q,
                 ok ? x + (size_t)g * d + k : x, ok);
    }
  } else {
    constexpr unsigned kRowStep = kThreads / kDK;
    const unsigned kk = tid % kDK;
#pragma unroll 4
    for (unsigned i = 0; i < 2 * kTile / kRowStep; ++i) {
      const unsigned row = tid / kDK + kRowStep * i;
      const int g = (i < kTile / kRowStep ? i0 : j0 - kTile) + int(row);
      const int k = k0 + kk;
      const bool ok = g < n && k < d;
      cp_async4(dst + row * kXStride + kk, ok ? x + (size_t)g * d + k : x,
                ok);
    }
  }
  if (vec_n) {
    copy_m_share<true>(s, stages, m, mij, mji, i0, j0, n, tid);
  } else {
    copy_m_share<false>(s, stages, m, mij, mji, i0, j0, n, tid);
  }
  cp_async_commit();
}

// Stores a W tile staged in shared memory to rows r0g.., columns c0g.. of w.
__device__ __forceinline__ void store_tile(const float* src,
                                           float* __restrict__ w, int r0g,
                                           int c0g, int n, bool vec_n,
                                           int tid) {
  if (vec_n) {
    for (int c = tid; c < kTile * (kTile / 4); c += kThreads) {
      const int r = c / (kTile / 4), q = c % (kTile / 4);
      const int gr = r0g + r, gc = c0g + 4 * q;
      if (gr < n && gc < n) {
        *reinterpret_cast<float4*>(w + (size_t)gr * n + gc) =
            *reinterpret_cast<const float4*>(src + r * kMStride + 4 * q);
      }
    }
  } else {
    for (int c = tid; c < kTile * kTile; c += kThreads) {
      const int r = c / kTile, q = c % kTile;
      const int gr = r0g + r, gc = c0g + q;
      if (gr < n && gc < n) w[(size_t)gr * n + gc] = src[r * kMStride + q];
    }
  }
}

// K1's d2 pass over its queue of ``kept`` entries (positions ri * kTile +
// cj in the tiles): a group of kDiffLanes lanes an entry, kDiffEntries
// entries a group at once (their loads issued together, so a group waits
// on L2 once for all of them), each lane the features 4 j + 4 kDiffLanes t
// (16-byte loads) or j + kDiffLanes t, as one fmaf chain an entry; the
// group's butterfly sums them.  Writes W = exp(-4 d2 / (eps_i eps_j)) m,
// 0 where d2 == 0, to both tiles.
__device__ __forceinline__ void kept_d2_pass(
    const unsigned short* queue, int kept, const float* __restrict__ x,
    const float* re, float* mij, float* mji, int i0, int j0, int d,
    bool vec_x, int tid) {
  constexpr int kGroupsPerBlock = kThreads / kDiffLanes;
  constexpr int kStep = kGroupsPerBlock * kDiffEntries;
  const int grp = tid / kDiffLanes, j = tid % kDiffLanes;
  // every lane of a warp runs the butterflies; entries past the queue
  // add 0 and write nothing
  for (int base = 0; base < kept; base += kStep) {
    int pos[kDiffEntries];
    const float* a[kDiffEntries];
    const float* b[kDiffEntries];
    float s[kDiffEntries];
#pragma unroll
    for (int q = 0; q < kDiffEntries; ++q) {
      const int e = base + q * kGroupsPerBlock + grp;
      pos[q] = e < kept ? queue[e] : -1;
      const int p = pos[q] < 0 ? 0 : pos[q];
      a[q] = x + (size_t)(i0 + p / kTile) * d;
      b[q] = x + (size_t)(j0 + p % kTile) * d;
      s[q] = 0.f;
    }
    if (vec_x) {
#pragma unroll 2
      for (int f = 4 * j; f < d; f += 4 * kDiffLanes) {
        float4 u[kDiffEntries], v[kDiffEntries];
#pragma unroll
        for (int q = 0; q < kDiffEntries; ++q) {
          if (pos[q] >= 0) {
            u[q] = __ldg(reinterpret_cast<const float4*>(a[q] + f));
            v[q] = __ldg(reinterpret_cast<const float4*>(b[q] + f));
          } else {
            u[q] = v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int q = 0; q < kDiffEntries; ++q) {
          const float t0 = u[q].x - v[q].x, t1 = u[q].y - v[q].y,
                      t2 = u[q].z - v[q].z, t3 = u[q].w - v[q].w;
          s[q] = fmaf(t0, t0, s[q]);
          s[q] = fmaf(t1, t1, s[q]);
          s[q] = fmaf(t2, t2, s[q]);
          s[q] = fmaf(t3, t3, s[q]);
        }
      }
    } else {
      for (int f = j; f < d; f += kDiffLanes) {
        float t[kDiffEntries];
#pragma unroll
        for (int q = 0; q < kDiffEntries; ++q) {
          t[q] = pos[q] >= 0 ? __ldg(a[q] + f) - __ldg(b[q] + f) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kDiffEntries; ++q) s[q] = fmaf(t[q], t[q], s[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kDiffEntries; ++q) {
#pragma unroll
      for (int off = 1; off < kDiffLanes; off <<= 1) {
        s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
      }
      if (pos[q] >= 0 && j == 0) {
        const int ri = pos[q] / kTile, cj = pos[q] % kTile;
        float* up = mij + ri * kMStride + cj;  // W[i, j]
        float* lo = mji + cj * kMStride + ri;  // W[j, i]
        const float e2 = expf(-4.f * s[q] * (re[ri] * re[kTile + cj]));
        const float w = s[q] > 0.f ? e2 * *up : 0.f;
        *up = w;
        *lo = w;
      }
    }
  }
}

// K1: see the header.
__global__ void __launch_bounds__(kThreads, kSymBlocksPerSM)
affinity_sym_kernel(const float* __restrict__ x,
                    const float* __restrict__ eps,
                    const float* __restrict__ m, float* __restrict__ w,
                    int n, int d, int tiles, int vec_x, int vec_n) {
  extern __shared__ __align__(16) float smem[];
  float* mij = smem;                // M[i-tile, j-tile], then W's
  float* mji = mij + kMFloats;      // M[j-tile, i-tile], then W's
  float* re = mji + kMFloats;       // [2 kTile] eps, then 1 / eps
  unsigned short* queue = reinterpret_cast<unsigned short*>(re + 2 * kTile);
  int* kept = reinterpret_cast<int*>(queue + kTile * kTile);

  int bi, bj;
  tile_pair(blockIdx.x, tiles, bi, bj);
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int tid = threadIdx.x;
  const int my_row = tile_row(tid, i0, j0);
  if (tid < 2 * kTile) {
    cp_async4(re + tid, my_row < n ? eps + my_row : eps, my_row < n);
  }
  if (tid == 0) *kept = 0;
  if (vec_n) {
    copy_m_share<true>(0, 1, m, mij, mji, i0, j0, n, tid);
  } else {
    copy_m_share<false>(0, 1, m, mij, mji, i0, j0, n, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // both M tiles, eps and the queue's length
  if (tid < 2 * kTile) re[tid] = my_row < n ? 1.f / re[tid] : 0.f;

  // each entry of both tiles becomes max(M[i, j], M[j, i]) where kept, else
  // 0; entry (ri, cj) alone reads and writes mij[ri][cj] and mji[cj][ri]
  for (int p = tid; p < kTile * kTile; p += kThreads) {
    const int ri = p / kTile, cj = p % kTile;
    float* up = mij + ri * kMStride + cj;  // W[i, j]
    float* lo = mji + cj * kMStride + ri;  // W[j, i]
    const float v = fmaxf(*up, *lo);
    const bool keep = i0 + ri != j0 + cj && v != 0.f;
    // one atomic a warp: kTile^2 is a multiple of kThreads, so every lane
    // of the warp is here
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    const int lane = tid & 31;
    int slot = 0;
    if (lane == 0 && mask != 0u) slot = atomicAdd(kept, __popc(mask));
    slot = __shfl_sync(0xffffffffu, slot, 0) +
           __popc(mask & ((1u << lane) - 1u));
    if (keep) queue[slot] = static_cast<unsigned short>(p);
    *up = keep ? v : 0.f;
    *lo = keep ? v : 0.f;
  }
  __syncthreads();  // the queue and 1 / eps
  kept_d2_pass(queue, *kept, x, re, mij, mji, i0, j0, d, vec_x, tid);
  __syncthreads();

  store_tile(mij, w, i0, j0, n, vec_n, tid);
  if (bi != bj) store_tile(mji, w, j0, i0, n, vec_n, tid);
}

// K3: see the header.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
affinity_tile_kernel(const float* __restrict__ x,
                     const float* __restrict__ eps,
                     const float* __restrict__ m, float* __restrict__ w,
                     int n, int d, int tiles, int vec_x, int vec_n) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [2 stages][2 kTile rows][kXStride]
  float* mij = xs + 2 * kXFloats;   // M[i-tile, j-tile], then W's
  float* mji = mij + kMFloats;      // M[j-tile, i-tile], then W's
  float* sq = mji + kMFloats;       // [2 kTile] norms of both tiles' rows
  float* re = sq + 2 * kTile;       // [2 kTile] eps, then 1 / eps

  int bi, bj;
  tile_pair(blockIdx.x, tiles, bi, bj);
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int tid = threadIdx.x;
  const int stages = d > 0 ? (d + kDK - 1) / kDK : 1;
  // threads 0 .. 2 kTile - 1 each keep the norm and 1 / eps of a staged row
  const bool norms = tid < 2 * kTile;
  const int my_row = tile_row(tid, i0, j0);
  if (norms) {
    cp_async4(re + tid, my_row < n ? eps + my_row : eps, my_row < n);
  }
  copy_stage(0, stages, x, m, xs, mij, mji, i0, j0, n, d, vec_x, vec_n, tid);

  // Group g forms the Gram tile over features g * kHalf .. of each stage;
  // thread (tx, ty) of the group owns rows ty + 8 r and columns tx + 8 c.
  // Each row's and column's features are read as float2 from the staged
  // rows (36 floats apart: no bank conflict across a quarter warp).
  const int g = tid / kGroupThreads, lt = tid % kGroupThreads;
  const int tx = lt % kSide, ty = lt / kSide;
  float acc[kPer][kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[r][c] = 0.f;
  }
  float nsq[kGroups] = {0.f, 0.f};  // staged row tid's norm, by group

  for (int s = 0; s < stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s has landed; buffer (s + 1) % 2 is free
    if (s == 0 && norms) re[tid] = my_row < n ? 1.f / re[tid] : 0.f;
    if (s + 1 < stages) {
      copy_stage(s + 1, stages, x, m, xs, mij, mji, i0, j0, n, d, vec_x,
                  vec_n, tid);
    }
    const float* xa = xs + (s & 1) * kXFloats + g * kHalf;
    const float* xb = xa + kTile * kXStride;
    // two features at a time, the next pair's operands loaded under the
    // current pair's FMA
    float2 a[2][kPer], b[2][kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      a[0][r] = *reinterpret_cast<const float2*>(
          xa + (ty + kSide * r) * kXStride);
      b[0][r] = *reinterpret_cast<const float2*>(
          xb + (tx + kSide * r) * kXStride);
    }
#pragma unroll
    for (int k = 0; k < kHalf / 2; ++k) {
      const int cur = k & 1, nxt = cur ^ 1;
      if (k + 1 < kHalf / 2) {
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          a[nxt][r] = *reinterpret_cast<const float2*>(
              xa + (ty + kSide * r) * kXStride + 2 * (k + 1));
          b[nxt][r] = *reinterpret_cast<const float2*>(
              xb + (tx + kSide * r) * kXStride + 2 * (k + 1));
        }
      }
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          acc[r][c] = fmaf(a[cur][r].x, b[cur][c].x, acc[r][c]);
          acc[r][c] = fmaf(a[cur][r].y, b[cur][c].y, acc[r][c]);
        }
      }
    }
    const float* row =
        xs + (s & 1) * kXFloats + (norms ? tid : 0) * kXStride;
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
#pragma unroll
      for (int k = h * kHalf; k < (h + 1) * kHalf; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + k);
        nsq[h] = fmaf(v.x, v.x, nsq[h]);
        nsq[h] = fmaf(v.y, v.y, nsq[h]);
        nsq[h] = fmaf(v.z, v.z, nsq[h]);
        nsq[h] = fmaf(v.w, v.w, nsq[h]);
      }
    }
  }
  if (norms) sq[tid] = nsq[0] + nsq[1];
  // The two groups' partial tiles meet in the free x buffers: group 0 keeps
  // rows r < kPer / 2 of its threads' tiles, group 1 the others, and each
  // hands the other half over.  A pair's sum is acc_0 + acc_1, as a norm's
  // is.
  constexpr int kKeep = kPer / 2;
  float* part = xs;
  __syncthreads();  // every thread is done with the x buffers
#pragma unroll
  for (int h = 0; h < kKeep; ++h) {
    const int r = ty + kSide * (g == 0 ? h + kKeep : h);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      part[r * kMStride + tx + kSide * c] =
          g == 0 ? acc[h + kKeep][c] : acc[h][c];
    }
  }
  __syncthreads();  // norms, 1 / eps, both M tiles and the partial tiles

  // Each thread turns its 18 entries of both M tiles into W in place.
#pragma unroll
  for (int h = 0; h < kKeep; ++h) {
    const int ri = ty + kSide * (g == 0 ? h : h + kKeep);
    const float sq_i = sq[ri], re_i = re[ri];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int cj = tx + kSide * c;
      const float dot =
          (g == 0 ? acc[h][c] : acc[h + kKeep][c]) + part[ri * kMStride + cj];
      const float d2 = fmaxf(sq_i + sq[kTile + cj] - 2.f * dot, 0.f);
      const float e = expf(-4.f * d2 * (re_i * re[kTile + cj]));
      float* up = mij + ri * kMStride + cj;  // W[i, j]
      float* lo = mji + cj * kMStride + ri;  // W[j, i]
      *up = e * *up;
      *lo = e * *lo;
    }
  }
  __syncthreads();

  store_tile(mij, w, i0, j0, n, vec_n, tid);
  if (bi != bj) store_tile(mji, w, j0, i0, n, vec_n, tid);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const float* x, const float* eps,
           const float* m, float* w, int n, int d, void* stream) {
  if (n < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = d % 4 == 0 && aligned16(x);
  const int vec_n = n % 4 == 0 && aligned16(m) && aligned16(w);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, eps, m, w, n, d, static_cast<int>(tiles), vec_x, vec_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K1 (symmetrized) or K3 (plain mask) on ``stream``; all pointers are
// device pointers to contiguous f32 arrays: x (n, d), eps (n,), the mask
// (n, n), w (n, n).  Each returns the CUDA error code of its calls (0 on
// success).
extern "C" int gll_affinity_sym_f32(const float* x, const float* eps,
                                    const float* m_raw, float* w, int n,
                                    int d, void* stream) {
  return launch(affinity_sym_kernel, kSymSmemBytes, x, eps, m_raw, w, n, d,
                stream);
}

extern "C" int gll_affinity_f32(const float* x, const float* eps,
                                const float* mask, float* w, int n, int d,
                                void* stream) {
  return launch(affinity_tile_kernel, kSmemBytes, x, eps, mask, w, n, d,
                stream);
}
