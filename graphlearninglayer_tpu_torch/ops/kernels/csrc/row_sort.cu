// Kernel P1: a bitonic sort of each row in registers, and a scale gated on
// a reduced scalar.
//
// gll_row_sort_f32: x (Q, M) float32 row-major, M a power of two up to
// 1,024.  Each row is sorted by the key (value, column index), ascending,
// or with descending = 1 by (-value, column index), so that of equal values
// the lower index comes first either way; NaN counts as larger than every
// number (last ascending, first descending), -0.0 as equal to +0.0: the
// order of torch.sort(..., stable=True).  Writes the sorted values (Q, M)
// float32 and their column indices (Q, M) int64.  (A NaN whose sign bit is
// set is last here, as on the CPU; torch.sort on the card orders NaNs by
// their bits, which puts it first.)
//
// gll_scale_if_max_positive_f32: out = 2 x where max(x) > 0 over the whole
// array, else x, bit for bit (a NaN anywhere makes the max NaN, and then
// out = x).
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
// Design of the sort.  Each element becomes one unsigned 64-bit key whose
// integer order is the sort's order: the high word maps the value to an
// order-preserving uint32 (-0.0 taken as +0.0, every NaN as one value above
// +inf; complemented for descending), the low word is the column.  Keys
// are unique, so any sorting network gives the one total order.  A row
// lies in the registers of T threads, R = M / T consecutive keys a thread
// (T = 32 up to M = 128, then R = 4: T = 64 at 256, 128 at 512, 256 at
// 1,024; below M = 32 a warp holds 32 / M rows, one key a lane).  With
// R = 4 a row takes 4 to 8 warps at the probe's shapes, so 256 rows of
// 512 (or 64 of 1,024) keep every SM busy; R = 8 or one warp a row left
// each warp a longer chain of dependent exchanges, and took longer.  A
// stage of the network whose partner distance j is below R is a
// compare-exchange between two of the thread's registers, with indices
// fixed at compile time; up to 32 R it is a __shfl_xor_sync with lane
// j / R; beyond (where a row spans warps) the keys cross through shared
// memory between two barriers.  x is read as float4 where it is 16-byte
// aligned, and also kept in shared memory, from which the sorted values
// are read back by their column, so that -0.0 and NaN come out bit for
// bit as they went in.  Values are written as float4 and indices as
// 16-byte pairs.
//
// Design of the gated scale.  Up to kClusterMax = 262,144 elements (the
// probe's block is 131,072), one launch: a thread-block cluster of up
// to 16 blocks holds the whole array in registers, ORs "some element > 0"
// and "some element is NaN" into each block's shared word, reads every
// block's word through distributed shared memory after one cluster
// barrier, then scales and writes what it holds; no flag in device memory
// needs a reset.  A thread holds kVec slots of 4 elements, float4s where x
// and out are 16-byte aligned, else scalars (chosen at run time), in
// ceil(n / (2,048 kVec)) blocks: kVec = 4 up to 131,072 elements (the
// probe's block, 16 blocks), 8 up to the limit.  The slot count is a
// template parameter: taken at run time (registers for 8 slots, the
// unused ones predicated off) it cost 0.8 us of 5.0 at the probe's block.
// Above kClusterMax, two kernels after a memset of the flag word: the
// first ORs the two bits into it (one atomic a block), the second scales,
// both on float4s where aligned.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLogM = 10;

// the order-preserving key of (v, column); flip = ~0u for descending
__device__ __forceinline__ unsigned long long sort_key(float v, int col,
                                                       unsigned flip) {
  unsigned u = __float_as_uint(v);
  if (v == 0.0f) u = 0u;                      // -0.0 as +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  if (isnan(v)) u = 0xffffffffu;              // every NaN above +inf
  return ((unsigned long long)(u ^ flip) << 32) | (unsigned)col;
}

// threads a row (T): 32 up to M = 128, then R = 4 keys a thread
constexpr int row_threads(int log_m) {
  return log_m <= 7 ? 32 : 1 << (log_m - 2);
}

template <int kLogM>
struct Shape {
  static constexpr int M = 1 << kLogM;
  static constexpr int T = row_threads(kLogM);
  static constexpr int R = M >= T ? M / T : 1;          // keys a thread
  static constexpr int kRowsPerGroup = M >= T ? 1 : T / M;
  static constexpr int kBlock = T > 128 ? T : 128;
  static constexpr int kGroups = kBlock / T;            // row groups a block
  static constexpr int kSpan = T * R;                   // a group's elements
};

// one stage of the network: partner distance j = 2^LJ within blocks of
// k = 2^LK sorted up (ascending) or down
template <int kLogM, int LK, int LJ>
__device__ __forceinline__ void stage(unsigned long long (&key)[Shape<kLogM>::R],
                                      int s, unsigned long long* xchg) {
  using S = Shape<kLogM>;
  constexpr int R = S::R, T = S::T, M = S::M;
  constexpr int k = 1 << LK, j = 1 << LJ;
  if constexpr (j < R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & j) == 0) {
        const bool up = (((s * R + r) & (M - 1)) & k) == 0;
        unsigned long long& a = key[r];
        unsigned long long& b = key[r | j];
        const bool swap = (a > b) == up;
        const unsigned long long lo = swap ? b : a, hi = swap ? a : b;
        a = lo;
        b = hi;
      }
    }
  } else {
    // j >= R: the partner of every key of this thread is the same
    // register of thread s ^ (j / R); keep the smaller where this thread
    // holds the lower position of an ascending pair or the upper of a
    // descending one
    const int e = (s * R) & (M - 1);
    const bool keep_min = (((e & k) == 0) == ((e & j) == 0));
    if constexpr (j < 32 * R) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned long long o =
            __shfl_xor_sync(0xffffffffu, key[r], j / R);
        key[r] = keep_min ? (o < key[r] ? o : key[r])
                          : (o > key[r] ? o : key[r]);
      }
    } else {
      static_assert(T > 32, "a row spans warps only for T > 32");
#pragma unroll
      for (int r = 0; r < R; ++r) xchg[r * T + s] = key[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned long long o = xchg[r * T + (s ^ (j / R))];
        key[r] = keep_min ? (o < key[r] ? o : key[r])
                          : (o > key[r] ? o : key[r]);
      }
      __syncthreads();
    }
  }
}

// stages (LK, LJ), (LK, LJ - 1), ..., (LK, 0), (LK + 1, LK), ... up to
// (kLogM, 0)
template <int kLogM, int LK, int LJ>
__device__ __forceinline__ void network(unsigned long long (&key)[Shape<kLogM>::R],
                                        int s, unsigned long long* xchg) {
  if constexpr (LK <= kLogM) {
    stage<kLogM, LK, LJ>(key, s, xchg);
    if constexpr (LJ > 0)
      network<kLogM, LK, LJ - 1>(key, s, xchg);
    else
      network<kLogM, LK + 1, LK>(key, s, xchg);
  }
}

template <int kLogM>
__global__ void __launch_bounds__(Shape<kLogM>::kBlock)
    row_sort_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    long long* __restrict__ idx, int q, unsigned flip) {
  using S = Shape<kLogM>;
  constexpr int M = S::M, T = S::T, R = S::R;
  // a copy of each group's rows, for the read-back by column; the keys'
  // exchange buffer where a row spans warps
  __shared__ float srow[S::kGroups * S::kSpan];
  __shared__ unsigned long long xchg[T > 32 ? S::kGroups * R * T : 1];
  const int g = threadIdx.x / T, s = threadIdx.x % T;
  const long long row0 =
      ((long long)blockIdx.x * S::kGroups + g) * S::kRowsPerGroup;
  const bool valid = row0 + (s * R) / M < q;   // this thread's row exists
  const long long off = row0 * M + (long long)s * R;
  float* mine = srow + g * S::kSpan + s * R;
  float v[R];
  if (valid) {
    if constexpr (R % 4 == 0) {
      if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(x + off + r));
          v[r] = f.x; v[r + 1] = f.y; v[r + 2] = f.z; v[r + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = __ldg(x + off + r);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = __ldg(x + off + r);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = 0.0f;
  }
  unsigned long long key[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mine[r] = v[r];
    key[r] = sort_key(v[r], (s * R + r) & (M - 1), flip);
  }
  network<kLogM, 1, 0>(key, s, xchg + (T > 32 ? g * R * T : 0));
  if constexpr (T > 32) __syncthreads(); else __syncwarp();
  if (!valid) return;
  // the group's copy of this thread's row starts at (s R) rounded down to M
  const float* rowcopy = srow + g * S::kSpan + ((s * R) & ~(M - 1));
  float outv[R];
  long long outi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int col = (int)(unsigned)key[r];
    outi[r] = col;
    outv[r] = rowcopy[col];
  }
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4)
      *reinterpret_cast<float4*>(vals + off + r) =
          make_float4(outv[r], outv[r + 1], outv[r + 2], outv[r + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) vals[off + r] = outv[r];
  }
  if constexpr (R % 2 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 2)
      *reinterpret_cast<longlong2*>(idx + off + r) =
          make_longlong2(outi[r], outi[r + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) idx[off + r] = outi[r];
  }
}

template <int kLogM>
int launch_sort(const float* x, float* vals, long long* idx, int q,
                unsigned flip, cudaStream_t st) {
  using S = Shape<kLogM>;
  const long long groups = ((long long)q + S::kRowsPerGroup - 1) /
                           S::kRowsPerGroup;
  const long long blocks = (groups + S::kGroups - 1) / S::kGroups;
  row_sort_kernel<kLogM><<<(unsigned)blocks, S::kBlock, 0, st>>>(
      x, vals, idx, q, flip);
  return static_cast<int>(cudaGetLastError());
}

template <int kLogM>
int dispatch_sort(int log_m, const float* x, float* vals, long long* idx,
                  int q, unsigned flip, cudaStream_t st) {
  if constexpr (kLogM > kMaxLogM) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log_m == kLogM) return launch_sort<kLogM>(x, vals, idx, q, flip, st);
    return dispatch_sort<kLogM + 1>(log_m, x, vals, idx, q, flip, st);
  }
}

// ---- the gated scale ----

constexpr int kScaleThreads = 512;
constexpr int kClusterBlocks = 16;     // the H100's largest cluster
constexpr long long kSlotSpan =        // one slot of each thread of a cluster
    (long long)kClusterBlocks * kScaleThreads * 4;
constexpr long long kClusterMax = 8 * kSlotSpan;   // 262,144

__device__ __forceinline__ unsigned flag_bits(float v) {
  return (v > 0.0f ? 1u : 0u) | (isnan(v) ? 2u : 0u);
}

// element c of slot k of this thread, in a block whose first element is
// first: a float4 where x and out are 16-byte aligned, else 4 scalars,
// each slot's warp on consecutive elements either way
__device__ __forceinline__ long long slot(long long first, bool aligned,
                                          int k, int c) {
  return aligned ? first + 4 * (k * kScaleThreads + threadIdx.x) + c
                 : first + (4 * k + c) * kScaleThreads + threadIdx.x;
}

// one cluster of gridDim.x blocks; each thread holds kVec slots in
// registers; a slot past n holds 0, which sets no bit
template <int kVec>
__global__ void __launch_bounds__(kScaleThreads)
    scale_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                         long long n, bool aligned) {
  __shared__ unsigned block_bits;
  __shared__ unsigned all_bits;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) block_bits = 0u;
  __syncthreads();
  const long long first = (long long)blockIdx.x * kScaleThreads * 4 * kVec;
  // every load is issued before any value is used
  float v[4 * kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long e0 = slot(first, aligned, k, 0);
    if (aligned && e0 + 3 < n) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(x + e0));
      v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long e = slot(first, aligned, k, c);
        v[4 * k + c] = e < n ? __ldg(x + e) : 0.0f;
      }
    }
  }
  unsigned bits = 0u;
#pragma unroll
  for (int r = 0; r < 4 * kVec; ++r) bits |= flag_bits(v[r]);
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(&block_bits, bits);
  cluster.sync();
  if (threadIdx.x < 32) {
    unsigned b = 0u;
    if (threadIdx.x < cluster.num_blocks())
      b = *cluster.map_shared_rank(&block_bits, threadIdx.x);
    b = __reduce_or_sync(0xffffffffu, b);
    if (threadIdx.x == 0) all_bits = b;
  }
  // no block may leave while another reads its word: arrive now, wait
  // before returning
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();
  // x itself where the max is not above 0 (x * 1 would change a NaN's
  // bits)
  const bool twice = all_bits == 1u;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    float w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = twice ? 2.0f * v[4 * k + c] : v[4 * k + c];
    const long long e0 = slot(first, aligned, k, 0);
    if (aligned && e0 + 3 < n) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(w[0], w[1], w[2],
                                                         w[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long e = slot(first, aligned, k, c);
        if (e < n) out[e] = w[c];
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// n <= kVec kSlotSpan in one cluster
template <int kVec>
int scale_in_one_cluster(const float* x, float* out, long long n,
                         cudaStream_t st) {
  const long long per_block = (long long)kScaleThreads * 4 * kVec;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaError_t err;
  if (blocks > 8) {   // clusters above 8 blocks are the H100's, not portable
    err = cudaFuncSetAttribute(scale_cluster_kernel<kVec>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kScaleThreads);
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, scale_cluster_kernel<kVec>, x, out, n,
                           aligned);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kWideThreads = 256;
constexpr int kWideBlocks = 1056;      // 8 blocks on each of 132 SMs

// the flag's two bits over x, one atomic a block (one a warp would queue
// ~30,000 atomics on one word when the max is positive); float4s where x
// is 16-byte aligned
__global__ void __launch_bounds__(kWideThreads)
    positive_or_nan_kernel(const float* __restrict__ x, long long n,
                           bool aligned, unsigned* flag) {
  __shared__ unsigned block_bits;
  if (threadIdx.x == 0) block_bits = 0u;
  __syncthreads();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = aligned ? n / 4 : 0;
  unsigned bits = 0u;
  for (long long i = t; i < n4; i += stride) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(x) + i);
    bits |= flag_bits(f.x) | flag_bits(f.y) | flag_bits(f.z) | flag_bits(f.w);
  }
  for (long long i = 4 * n4 + t; i < n; i += stride)
    bits |= flag_bits(__ldg(x + i));
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(&block_bits, bits);
  __syncthreads();
  if (threadIdx.x == 0 && block_bits) atomicOr(flag, block_bits);
}

// out = 2 x if the flag is exactly "some element > 0", else x; float4s
// where x and out are 16-byte aligned
__global__ void __launch_bounds__(kWideThreads)
    scale_by_flag_kernel(const float* __restrict__ x, float* __restrict__ out,
                         long long n, bool aligned, const unsigned* flag) {
  const bool twice = *flag == 1u;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = aligned ? n / 4 : 0;
  for (long long i = t; i < n4; i += stride) {
    float4 f = __ldg(reinterpret_cast<const float4*>(x) + i);
    if (twice) {
      f.x *= 2.0f; f.y *= 2.0f; f.z *= 2.0f; f.w *= 2.0f;
    }
    reinterpret_cast<float4*>(out)[i] = f;
  }
  for (long long i = 4 * n4 + t; i < n; i += stride)
    out[i] = twice ? 2.0f * x[i] : x[i];
}

int wide_grid(long long n) {
  const long long blocks = (n + 4LL * kWideThreads - 1) / (4LL * kWideThreads);
  return (int)(blocks < kWideBlocks ? blocks : kWideBlocks);
}

}  // namespace

// vals, idx = the rows of x sorted (see above); q >= 1, m a power of two in
// [1, 1024].  Returns the launch's cudaError_t (0 on success).
extern "C" int gll_row_sort_f32(const void* x, void* vals, void* idx, int q,
                                int m, int descending, void* stream) {
  int log_m = 0;
  while ((1 << log_m) < m) ++log_m;
  return dispatch_sort<0>(log_m, static_cast<const float*>(x),
                          static_cast<float*>(vals),
                          static_cast<long long*>(idx), q,
                          descending ? 0xffffffffu : 0u,
                          static_cast<cudaStream_t>(stream));
}

// out = 2 x if max(x) > 0 else x, over n >= 1 elements; flag is one
// unsigned word of scratch, used above kClusterMax elements only.
// Returns the first cudaError_t (0 on success).
extern "C" int gll_scale_if_max_positive_f32(const void* x, void* out,
                                             void* flag, long long n,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (n <= 4 * kSlotSpan) return scale_in_one_cluster<4>(xf, of, n, st);
  if (n <= kClusterMax) return scale_in_one_cluster<8>(xf, of, n, st);
  const bool x_aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool aligned = x_aligned && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  positive_or_nan_kernel<<<wide_grid(n), kWideThreads, 0, st>>>(
      xf, n, x_aligned, static_cast<unsigned*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scale_by_flag_kernel<<<wide_grid(n), kWideThreads, 0, st>>>(
      xf, of, n, aligned, static_cast<const unsigned*>(flag));
  return static_cast<int>(cudaGetLastError());
}
