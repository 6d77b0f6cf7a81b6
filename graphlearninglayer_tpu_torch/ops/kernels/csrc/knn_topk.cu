// K2: exact fused KNN: all-pairs squared distance + running top-k per row.
//
// Replaces the Pallas TPU kernel
//   graphlearninglayer_tpu/ops/kernels/knn_topk.py::fused_knn
//   (kernel body _make_kernel, with its bitonic roll network).
// For x (n, d) f32 it returns, for every row i, the k (<= 64) smallest
//   d2[i,j] = max(|x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, 0)
// in ascending order, with self pinned first (d2[i,i] := -1 during
// selection) and ties kept at the lower index, as nbr (n, k) int64, and
// the kept edges' squared distances as dist2 (n, k) f32, each formed again
// from the endpoints' difference, sum_f (x_i,f - x_j,f)^2: exactly 0 for
// self and for equal rows, where the Gram form can leave a rounding
// residue, and within that form's rounding elsewhere (the port's d2 rule
// for every kept edge).  No distance panel is written to device memory.  A row range [r0, r1) returns the lists of those query rows
// only, (r1 - r0, k), against all n rows (a rank's share of a sharded
// build); each row's list is the full call's bit for bit, because a row's
// distances and its selection depend on nothing but its own row.
//
// Bound on an H100 SXM at the transductive eval's shape (n = 60,250,
// d = 128, k = 50):
//   operations: d2 is symmetric, so the function needs one triangle of
//               the Gram matrix, n (n + 1) / 2 d = 2.3e11 f32 FMA (0.46
//               TFLOP counting an FMA as two); at the 67 TFLOP/s
//               non-tensor f32 rate that is 6.9 ms;
//   bytes:      x read once (31 MB) + nbr and dist2 written (36 MB) = 67 MB,
//               20 us at 3.35 TB/s.
// So the function is bound by operations, by a factor of ~350.
//
// Design (Hopper, plain f32 FMA: no TF32, no tensor cores):
//   1. knn_prep_kernel writes the row norms and a copy of x transposed to
//      (d_pad, n_pad), zero past n and d (n_pad a multiple of 128, d_pad of
//      32), so that every tile row is 16-byte aligned for cp.async whatever
//      n and d are.
//   2. knn_scan_kernel: a block of 512 threads owns a panel of rows and
//      scans every column.  Whole waves of 128-row panels, one block an SM,
//      come first; the rows left over go to one more wave of smaller
//      blocks, R = 1..8 rows a warp (at the eval's 60,250 rows: 396 panels,
//      then 120 blocks of 80 rows), so the last wave spreads over the SMs.
//      The panel's first 128 features stay resident in shared memory for
//      the whole scan; candidate tiles of 128 columns stream through a
//      double-buffered ring of 32-feature slices filled by cp.async one
//      slice ahead, under the FMA loop.  Past 128 features the panel's
//      slices stream beside the candidates.
//   3. Each thread holds an R x 4 register tile: warp w forms its R rows x
//      all 128 columns of the tile, four columns a lane, from a transposed
//      layout read without bank conflicts (three float4 loads per 32 FMA).
//   4. Survivor-only selection, by the warp that owns the rows: each row
//      keeps its 64 smallest (d2, index) pairs sorted in shared memory, as
//      64-bit keys whose unsigned order is the lexicographic one, and its
//      k-th key as its threshold.  After a tile a cheap test on the dot
//      products (a lane's four columns against the row's bound, with a
//      margin for rounding) picks the rows that may have survivors; only
//      those are turned into d2 and tested exactly.  Survivors are queued,
//      each lane at its lower lanes' count, and 32 queued survivors are
//      merged into the list at once (bitonic sort of the 32, the lower
//      half of a bitonic merge, its sort), so that the row's threshold
//      tightens before its next tile.
//      No block barrier and no atomic serve the selection.  Ties keep the
//      lower index because the keys compare (d2, index); self is pinned by
//      d2 := -1.
//   5. The epilogue writes each row's list, a lane a neighbor: its index,
//      and its d2 from the two rows of x (row-major, in L2; 16-byte loads
//      where d % 4 == 0), one fmaf chain in feature order.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py and k2_turns.py;
// PERF.md): 28.6 ms at the eval's shape against 44.3 ms for the previous
// design (64-row blocks, 4 x 4 tiles, lists in registers) timed in turns
// in the same call, 1.55x; 24% of the bound, 32 TFLOP/s counting both
// triangles.  At n = 1500, k = 25: 0.15 ms against 0.37-0.41 ms.
// What still holds it back: both triangles of the Gram matrix are formed,
// twice the operations of the bound; a block of 80 rows still streams
// every candidate tile, so the last wave costs more than its share of
// rows; after each tile every warp runs its selection between the same
// two block barriers, so the FMA pipes wait for it.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // query rows per block (the panel)
constexpr int kBN = 128;          // candidates per column tile
constexpr int kDK = 32;           // features per ring stage
constexpr int kStages = 2;        // ring depth
constexpr int kResident = 128;    // up to this d, the whole panel stays
constexpr int kResidentWide = 64; // beyond it, this many features stay
constexpr int kThreads = kBM * kBN / 32;     // an 8 x 4 register tile each
constexpr int kWarps = kThreads / 32;
constexpr int kList = 64;         // list width (the largest k)
constexpr int kQueue = 64;        // survivor slots per row
constexpr int kFlush = 32;        // survivors merged into a list at once
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBM == kBN, "panels and column tiles share the padding");
static_assert(kBM == 128 && kBN == 128 && kThreads == 512,
              "a warp's 8 rows x 4 columns a lane cover 8 rows x 128 columns, "
              "16 warps the 128 x 128 tile");
static_assert((kDK * kBN / 4) % kThreads == 0, "whole copies per thread");
static_assert(kResident % kDK == 0 && kResidentWide % kDK == 0,
              "a stage is resident or streamed");
static_assert(kFlush == 32 && kQueue == 2 * kFlush && kList == 64,
              "a flush sorts one survivor a lane into two list entries a "
              "lane");

__host__ __device__ inline int resident_features(int d_pad) {
  return d_pad <= kResident ? d_pad : kResidentWide;
}

__host__ __device__ inline int stage_floats(int d_pad) {
  return kDK * (kBN + (d_pad > kResident ? kBM : 0));
}

// Shared memory of knn_scan_kernel, in the order of its carve-up: the
// panel, the ring, the rows' lists, queues and thresholds (as keys) and
// their queue lengths.
size_t scan_smem_bytes(int d_pad) {
  return sizeof(float) * ((size_t)resident_features(d_pad) * kBM +
                          (size_t)kStages * stage_floats(d_pad)) +
         sizeof(unsigned long long) * ((size_t)kBM * (kList + kQueue + 1)) +
         sizeof(int) * kBM;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row norms and x transposed to xt (d_pad, n_pad), zero past n and d.  A
// block of 32 x 8 threads takes 32 rows; warp y sums rows y, y + 8, ... in
// the order of the lanes' strided partial sums and one butterfly.
__global__ void __launch_bounds__(256)
knn_prep_kernel(const float* __restrict__ x, float* __restrict__ xt,
                float* __restrict__ sq, int n, int d, int n_pad,
                int d_pad) {
  __shared__ float tile[32][33];
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int r0 = blockIdx.x * 32;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < d_pad; c0 += 32) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = wy + 8 * m;
      const int r = r0 + i;
      const int c = c0 + lane;
      const float v = (r < n && c < d) ? x[(size_t)r * d + c] : 0.f;
      s[m] = fmaf(v, v, s[m]);
      tile[i][lane] = v;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = c0 + wy + 8 * m;
      if (c < d_pad) xt[(size_t)c * n_pad + r0 + lane] = tile[lane][wy + 8 * m];
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float v = s[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) sq[r0 + wy + 8 * m] = v;
  }
}

// A (d2, index) pair as one key whose unsigned order is the pairs'
// lexicographic order: the float's bits made monotonic (+0 for -0) above
// the index.
__device__ __forceinline__ unsigned long long pack(float v, int i) {
  const unsigned b = __float_as_uint(v + 0.f);
  const unsigned u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(i);
}

__device__ __forceinline__ float key_d2(unsigned long long key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key));
}

// Compare-exchange with the lane ``lane ^ j``: keep the smaller key where
// ``keep_min``, else the larger.
__device__ __forceinline__ void cmpx(unsigned long long& key, int j,
                                     bool keep_min) {
  const unsigned long long o = __shfl_xor_sync(kFull, key, j);
  key = keep_min ? (o < key ? o : key) : (o < key ? key : o);
}

// Merges the first 32 of a row's queued survivors (in no order; fewer
// than 32 are padded) into its sorted list of 64 keys, by one warp that
// holds list entries lane and lane + 32: a bitonic sort of the 32, one a
// lane; the lower half of a bitonic merge with the list, which leaves the
// 64 smallest keys as a bitonic sequence; and its sort.  Refreshes the
// row's threshold, moves the rest of the queue to its front and returns
// its length.
__device__ __forceinline__ int flush32(unsigned long long* list,
                                       unsigned long long* queue, int cnt,
                                       int k, int lane,
                                       unsigned long long* thr,
                                       unsigned long long pad) {
  unsigned long long b = lane < cnt ? queue[lane] : pad;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      cmpx(b, j, ((lane & size) == 0) == ((lane & j) == 0));
    }
  }
  unsigned long long a0 = list[lane], a1 = list[lane + 32];
  // list[32 + lane] against queue[31 - lane]; list[lane] meets padding
  const unsigned long long r = __shfl_sync(kFull, b, 31 - lane);
  a1 = r < a1 ? r : a1;
  if (a1 < a0) {
    const unsigned long long t = a0;
    a0 = a1;
    a1 = t;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const bool lower = (lane & j) == 0;
    cmpx(a0, j, lower);
    cmpx(a1, j, lower);
  }
  list[lane] = a0;
  list[lane + 32] = a1;
  if (lane == ((k - 1) & 31)) {
    *thr = k > 32 ? a1 : a0;
  }
  const int rest = cnt - 32;
  unsigned long long m = 0ull;
  if (lane < rest) m = queue[32 + lane];
  __syncwarp();
  if (lane < rest) queue[lane] = m;
  __syncwarp();
  return rest > 0 ? rest : 0;
}

// Features [f0, f0 + nf) of the block's rows into ``dst`` ([nf][kBM]):
// warp w's R rows go to slots 8w .. 8w + R - 1; with R = 8 the slots are
// the rows in order and copy 16 bytes at a time.
template <int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* xt,
                                          int n_pad, int row0, int f0,
                                          int nf, int t) {
  if (R == 8) {
    for (int e = t; e < nf * (kBM / 4); e += kThreads) {
      const int c = e / (kBM / 4);
      const int q = e % (kBM / 4);
      cp_async16(dst + c * kBM + 4 * q,
                 xt + (size_t)(f0 + c) * n_pad + row0 + 4 * q);
    }
  } else {
    for (int e = t; e < nf * kWarps * R; e += kThreads) {
      const int c = e / (kWarps * R);
      const int r = e % (kWarps * R);
      if (row0 + r < n_pad) {
        cp_async4(dst + c * kBM + 8 * (r / R) + r % R,
                  xt + (size_t)(f0 + c) * n_pad + row0 + r);
      }
    }
  }
}

// sum_f (x[i, f] - x[j, f])^2 as one fmaf chain in feature order, 16 bytes
// a load where ``vec`` (d % 4 == 0 and x 16-byte aligned).
__device__ __forceinline__ float diff_d2(const float* __restrict__ x, int i,
                                         int j, int d, bool vec) {
  const float* a = x + (size_t)i * d;
  const float* b = x + (size_t)j * d;
  float s = 0.f;
  if (vec) {
#pragma unroll 4
    for (int f = 0; f < d; f += 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(a + f));
      const float4 v = __ldg(reinterpret_cast<const float4*>(b + f));
      const float t0 = u.x - v.x, t1 = u.y - v.y, t2 = u.z - v.z,
                  t3 = u.w - v.w;
      s = fmaf(t0, t0, s);
      s = fmaf(t1, t1, s);
      s = fmaf(t2, t2, s);
      s = fmaf(t3, t3, s);
    }
  } else {
#pragma unroll 4
    for (int f = 0; f < d; ++f) {
      const float t = __ldg(a + f) - __ldg(b + f);
      s = fmaf(t, t, s);
    }
  }
  return s;
}

// One block scans every column for kWarps * R rows from row_base +
// blockIdx.x * kWarps * R, R rows a warp, and writes the rows of
// [row_lo, row_hi) among them to row gi - row_lo of nbr and dist2.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
knn_scan_kernel(const float* __restrict__ xt, const float* __restrict__ sq,
                const float* __restrict__ x, int n, int n_pad, int d,
                int d_pad, int vec_x, int k, int row_base, int row_lo,
                int row_hi, int64_t* __restrict__ nbr,
                float* __restrict__ dist2) {
  extern __shared__ __align__(16) float smem[];
  const int d_res = resident_features(d_pad);
  const int sfl = stage_floats(d_pad);
  float* panel = smem;                        // [d_res][kBM]
  // kStages x [kDK][kBN] candidates (+ [kDK][kBM] panel slice past d_res)
  float* ring = panel + d_res * kBM;
  // [kBM][kList] sorted keys, then [kBM][kQueue] survivors' keys
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(ring + kStages * sfl);
  unsigned long long* queue = list + kBM * kList;
  unsigned long long* thr = queue + kBM * kQueue;  // [kBM] k-th keys
  int* queue_n = reinterpret_cast<int*>(thr + kBM);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row0 = row_base + blockIdx.x * (kWarps * R);
  const int row_end = row0 + kWarps * R;
  const int nch = d_pad / kDK;
  const int steps = (n_pad / kBN) * nch;
  const unsigned long long pad = pack(INFINITY, INT_MAX);

  for (int e = t; e < kBM * kList; e += kThreads) {
    list[e] = pad;
  }
  for (int r = t; r < kBM; r += kThreads) {
    thr[r] = pad;
    queue_n[r] = 0;
  }

  // the resident panel, in the first copy group with ring step 0
  copy_rows<R>(panel, xt, n_pad, row0, 0, d_res, t);
  // ring step s: feature slice s % nch of column tile s / nch (and
  // of the panel, past the resident features)
  auto load_step = [&](int s) {
    float* st = ring + (s % kStages) * sfl;
    const int col0 = (s / nch) * kBN;
    const int f0 = (s % nch) * kDK;
#pragma unroll
    for (int p = 0; p < (kDK * kBN / 4) / kThreads; ++p) {
      const int e = p * kThreads + t;
      const int c = e / (kBN / 4);
      const int q = e % (kBN / 4);
      cp_async16(st + c * kBN + 4 * q,
                 xt + (size_t)(f0 + c) * n_pad + col0 + 4 * q);
    }
    if (f0 >= d_res) copy_rows<R>(st + kDK * kBN, xt, n_pad, row0, f0, kDK, t);
  };
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < steps) load_step(p);
    cp_async_commit();
  }

  // Warp w owns rows row0 + R w .. row0 + R w + R - 1, at panel slots
  // 8w .. 8w + R - 1: it forms their d2 against all 128 columns of a tile
  // (four a lane) and alone queues, merges and keeps their lists, so the
  // selection needs no block barrier.
  int lrow[R];
  float sqi[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lrow[i] = 8 * warp + i;
    const int gi = row0 + R * warp + i;
    sqi[i] = gi < n_pad ? sq[gi] : 0.f;
  }

  float acc[R][4];
  int gj[4];
  float sqj[4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s (and the panel) have landed
    __syncthreads();               // ... for every thread; stage s - 1 is free
    if (s + kStages - 1 < steps) load_step(s + kStages - 1);
    cp_async_commit();
    const int f = s % nch;
    if (f == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const int col0 = (s / nch) * kBN;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // read now, used after the tile
        gj[j] = col0 + 4 * lane + j;
        sqj[j] = sq[gj[j]];
      }
    }
    // the rows' bounds, read before the tile's last slice so that their
    // latency hides under its FMA
    float bound[R];
    if (f == nch - 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        bound[i] = key_d2(thr[lrow[i]]);
      }
    }
    const float* bs = ring + (s % kStages) * sfl;
    const float* as = f * kDK < d_res ? panel + f * kDK * kBM : bs + kDK * kBN;
#pragma unroll
    for (int c = 0; c < kDK; ++c) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + c * kBM + 8 * warp);
      const float4 a1 =
          R > 4 ? *reinterpret_cast<const float4*>(as + c * kBM + 8 * warp + 4)
                : a0;
      const float4 b4 =
          *reinterpret_cast<const float4*>(bs + c * kBN + 4 * lane);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (f != nch - 1) continue;

    // Which rows may have survivors.  Inside the matrix (no self, no
    // padding) a cheap test on the dot products: the lane's smallest
    // sq_j - 2 acc plus sq_i against the row's bound, with a margin of
    // 1e-5 (sq_i + max sq_j), far above the float32 rounding of either form
    // of d2 (a few 2^-24 of terms of that size); only the rows that pass
    // are turned into d2 and tested exactly, so the margin changes no
    // result.  Elsewhere d2 in place (self := -1, NaN past n, which no
    // comparison passes) and its minimum.
    const int col0 = (s / nch) * kBN;
    const bool inner = row_end <= n && col0 + kBN <= n &&
                       (row_end <= col0 || col0 + kBN <= row0);
    unsigned rows = 0u;
    if (inner) {
      const float smax = fmaxf(fmaxf(sqj[0], sqj[1]), fmaxf(sqj[2], sqj[3]));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float m = fminf(fminf(fmaf(-2.f, acc[i][0], sqj[0]),
                                    fmaf(-2.f, acc[i][1], sqj[1])),
                              fminf(fmaf(-2.f, acc[i][2], sqj[2]),
                                    fmaf(-2.f, acc[i][3], sqj[3])));
        rows |= (m + sqi[i] <= bound[i] + 1e-5f * (sqi[i] + smax) ? 1u : 0u)
                << i;
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int gi = row0 + R * warp + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = fmaxf(sqi[i] + sqj[j] - 2.f * acc[i][j], 0.f);
          acc[i][j] = gi < n && gj[j] < n ? (gi == gj[j] ? -1.f : e) : NAN;
        }
        const float m =
            fminf(fminf(acc[i][0], acc[i][1]), fminf(acc[i][2], acc[i][3]));
        rows |= (m <= bound[i] ? 1u : 0u) << i;
      }
    }
    const unsigned any = __reduce_or_sync(kFull, rows);
    if (any == 0u) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!(any & (1u << i))) continue;  // warp-uniform
      if (inner) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaxf(sqi[i] + sqj[j] - 2.f * acc[i][j], 0.f);
      }
      const int lr = lrow[i];
      unsigned long long tk = thr[lr];
      unsigned bits = 0u;
      if (rows & (1u << i)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (pack(acc[i][j], gj[j]) < tk) bits |= 1u << j;
        }
      }
      int cnt = queue_n[lr];
      // each lane's survivor count, as three bit planes: the lane's offset
      // in the queue is its lower lanes' count
      const int mine_n = __popc(bits);
      const unsigned b0 = __ballot_sync(kFull, mine_n & 1);
      const unsigned b1 = __ballot_sync(kFull, mine_n & 2);
      const unsigned b2 = __ballot_sync(kFull, mine_n & 4);
      const int total = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
      if (cnt + total <= kQueue) {
        const unsigned lt = (1u << lane) - 1u;
        int o = lr * kQueue + cnt + __popc(b0 & lt) + 2 * __popc(b1 & lt) +
                4 * __popc(b2 & lt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((bits >> j) & 1u) queue[o++] = pack(acc[i][j], gj[j]);
        }
        cnt += total;
      } else {
        // queue them in lane order; a full queue is merged on the spot and
        // the rest are tested again against the tightened threshold
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned mj = __ballot_sync(kFull, (bits >> j) & 1u);
          while (mj != 0u) {
            const bool mine = (mj >> lane) & 1u;
            const int rank = __popc(mj & ((1u << lane) - 1u));
            const bool put = mine && rank < kQueue - cnt;
            if (put) queue[lr * kQueue + cnt + rank] = pack(acc[i][j], gj[j]);
            cnt = min(cnt + __popc(mj), kQueue);
            mj = __ballot_sync(kFull, mine && !put);
            if (mj != 0u) {
              __syncwarp();
              cnt = flush32(list + lr * kList, queue + lr * kQueue, cnt, k,
                            lane, thr + lr, pad);
              tk = thr[lr];
              mj = __ballot_sync(kFull, ((mj >> lane) & 1u) &&
                                            pack(acc[i][j], gj[j]) < tk);
            }
          }
        }
      }
      // a full flush at once, so that the row's threshold tightens before
      // its next tile
      while (cnt >= kFlush) {
        __syncwarp();
        cnt = flush32(list + lr * kList, queue + lr * kQueue, cnt, k, lane,
                      thr + lr, pad);
      }
      if (lane == 0) queue_n[lr] = cnt;
      __syncwarp();
    }
  }

  // merge what the queues still hold and write the rows out
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int lr = lrow[i];
    int cnt = queue_n[lr];
    while (cnt > 0) {
      cnt = flush32(list + lr * kList, queue + lr * kQueue, cnt, k, lane,
                    thr + lr, pad);
    }
    const int gi = row0 + R * warp + i;
    if (gi < row_lo || gi >= row_hi) continue;
    const size_t out = (size_t)(gi - row_lo) * k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      if (e >= k) continue;
      const int vi = key_index(list[lr * kList + e]);
      nbr[out + e] = vi;
      dist2[out + e] = diff_d2(x, gi, vi, d, vec_x);
    }
  }
}

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

struct Layout {
  int n_pad, d_pad;
  size_t xt, sq, bytes;
};

// Offsets of the workspace's parts: x transposed, then the norms.
Layout layout(int n, int d) {
  Layout l;
  l.n_pad = (n + kBN - 1) / kBN * kBN;
  l.d_pad = (d + kDK - 1) / kDK * kDK;
  l.xt = 0;
  l.sq = align256(sizeof(float) * (size_t)l.d_pad * l.n_pad);
  l.bytes = l.sq + align256(sizeof(float) * (size_t)l.n_pad);
  return l;
}

template <int R>
cudaError_t launch_scan_r(const float* xt, const float* sq, const float* x,
                          const Layout& l, int n, int d, int vec_x, int k,
                          int row_base, int row_lo, int row_hi, int blocks,
                          int64_t* nbr, float* dist2, cudaStream_t s) {
  const size_t smem = scan_smem_bytes(l.d_pad);
  cudaError_t err = cudaFuncSetAttribute(
      knn_scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  knn_scan_kernel<R><<<blocks, kThreads, smem, s>>>(
      xt, sq, x, n, l.n_pad, d, l.d_pad, vec_x, k, row_base, row_lo, row_hi,
      nbr, dist2);
  return cudaGetLastError();
}

// knn_scan_kernel<r> over ``blocks`` blocks from row ``row_base``, for
// r = 1 .. R.
template <int R>
cudaError_t launch_scan(int r, const float* xt, const float* sq,
                        const float* x, const Layout& l, int n, int d,
                        int vec_x, int k, int row_base, int row_lo,
                        int row_hi, int blocks, int64_t* nbr, float* dist2,
                        cudaStream_t s) {
  if (r == R) {
    return launch_scan_r<R>(xt, sq, x, l, n, d, vec_x, k, row_base, row_lo,
                            row_hi, blocks, nbr, dist2, s);
  }
  if constexpr (R > 1) {
    return launch_scan<R - 1>(r, xt, sq, x, l, n, d, vec_x, k, row_base,
                              row_lo, row_hi, blocks, nbr, dist2, s);
  }
  return cudaErrorInvalidValue;
}

bool valid(int n, int d, int k) {
  return n >= 1 && d >= 1 && k >= 1 && k <= kList && k <= n;
}

bool valid_rows(int n, int r0, int r1) {
  return 0 <= r0 && r0 < r1 && r1 <= n;
}

}  // namespace

// Bytes of device workspace gll_knn_topk_f32 needs for these arguments
// (the transposed copy of x and the norms); 0 if it would refuse them.
extern "C" size_t gll_knn_topk_workspace(int n, int d, int k) {
  return valid(n, d, k) ? layout(n, d).bytes : 0;
}

// Launches K2 on ``stream`` for the query rows [r0, r1) (0 and n for all
// of them).  Device pointers: x (n, d) f32 contiguous, work
// (gll_knn_topk_workspace bytes, 256-byte aligned), nbr (r1 - r0, k) int64
// and dist2 (r1 - r0, k) f32 outputs.  Requires 1 <= k <= min(64, n) and
// 0 <= r0 < r1 <= n.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int gll_knn_topk_f32(const float* x, void* work, int64_t* nbr,
                                float* dist2, int n, int d, int k, int r0,
                                int r1, void* stream) {
  if (!valid(n, d, k) || !valid_rows(n, r0, r1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout l = layout(n, d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(work);
  float* xt = reinterpret_cast<float*>(base + l.xt);
  float* sq = reinterpret_cast<float*>(base + l.sq);

  knn_prep_kernel<<<l.n_pad / 32, dim3(32, 8), 0, s>>>(x, xt, sq, n, d,
                                                        l.n_pad, l.d_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // Whole waves of 128-row panels, one block an SM; the rows left over go
  // to one wave of smaller blocks, R = 1..8 rows a warp, so that the last
  // wave spreads over every SM.  The panels start at r0 rounded down to a
  // multiple of 4, where the 16-byte panel copies stay aligned (rows below
  // r0 are scanned and not written), and stay inside the padded rows.
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int first = r0 & ~3;
  const int span = (r1 - first + kBM - 1) / kBM * kBM;
  const int full = (span < l.n_pad - first ? span : l.n_pad - first) / kBM /
                   sms * sms;
  const int vec_x =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (full > 0) {
    err = launch_scan<8>(8, xt, sq, x, l, n, d, vec_x, k, first, r0, r1, full,
                         nbr, dist2, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rest = r1 - first - full * kBM;
  if (rest > 0) {
    const int per_block = (rest + sms - 1) / sms;
    const int r = (per_block + kWarps - 1) / kWarps;
    const int rows = kWarps * r;
    err = launch_scan<8>(r, xt, sq, x, l, n, d, vec_x, k, first + full * kBM,
                         r0, r1, (rest + rows - 1) / rows, nbr, dist2, s);
  }
  return static_cast<int>(err);
}
