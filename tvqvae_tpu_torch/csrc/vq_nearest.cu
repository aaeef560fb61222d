// Nearest-code assignment and codebook statistics for vector quantization.
//
// Replaces the TPU kernel tvqvae_tpu/ops/vq_pallas.py::_kernel (reached
// through nearest_codes_stats_pallas). For flat (M, D) and embed (K, D), all
// float32 and row-major, it computes
//
//   dist[m, k]   = (2 * <x_m, e_k> - |x_m|^2) - |e_k|^2   (exact fp32 FFMA)
//   idx[m]       = argmax_k dist[m, k]   (first index on ties, NaN as max)
//   counts[k]    = #{m : idx[m] == k}
//   embed_sum[k] = sum over m with idx[m] == k of x_m
//
// What bounds it on an H100. At the published shapes (D=128, K=32, M = 864
// for LF and 3456 for HF) one call reads ~1.8 MB and does ~28 MFLOP: bytes
// bound it (0.5 us at 3.35 TB/s), and in practice latency and launches. At
// K >= 512 the fp32 dot products bound it (1.8 GFLOP at K=2048, 27 us at the
// 67 TFLOP/s fp32 rate outside the tensor cores; no TF32, since the
// reference computes at Precision.HIGHEST and the tokens sit on a knife edge).
//
// What the design does about it:
//   - x is read from device memory once. A block owns a tile of 64 rows,
//     copied into shared memory with 16-byte cp.async (4-byte copies where
//     D % 4 != 0 or a pointer is not 16-byte aligned), zero-padded to a
//     multiple of 64 columns. The tile's statistics come from that copy.
//   - The codebook streams through a four-stage cp.async ring of slices of
//     KC codes x SD dims. Each thread keeps a register tile of accumulators
//     fed by float4 shared loads; slice rows are SD + 4 floats apart, so the
//     float4 reads of a quarter warp hit distinct bank groups. Two tilings:
//     K <= 32 (the published codebooks) takes chunks of 32 codes, 4 rows x
//     2 codes a thread, so no padding codes are computed; larger K takes
//     chunks of 128 codes, 8 rows x 4 codes a thread (the 32 lanes of a warp
//     share their rows, so the x reads are broadcasts). |e|^2 is summed from
//     the same slices, |x|^2 once per tile.
//   - Where the row tiles alone cannot fill the card and K spans several
//     chunks, the wrapper splits the chunks over a second grid
//     dimension. Each (row, split) writes its winner to scratch, and a merge
//     kernel folds the splits in increasing order with `better`, re-reading
//     the tile from L2.
//   - Per-tile statistics, no atomics: a tile sums its rows per code in row
//     order from shared memory (one warp a code, one lane a column) into
//     part[tile, slot, :] and pcnt[tile, slot]. With K <= 64 the slot is the
//     code; with more codes a tile holds at most 64, so it writes a compact
//     table (slot_tab[tile, k] is -1 where code k is absent, else its slot).
//     A final kernel walks each code's tiles in increasing order with 16-32
//     loads in flight. The order is fixed, so two calls give the same bits.
// At most three launches: assign (with the statistics fused when there is no
// split), merge + statistics (split only), final reduction.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;                       // rows of x per block
constexpr int kPadDims = 64;                        // x rows are padded to a multiple
constexpr int kMaxChunkCodes = 128;                 // widest chunk of codes
constexpr int kStages = 4;                          // cp.async ring depth
constexpr int kMaxDim = 512;                        // the wrapper checks D <= kMaxDim
constexpr int kFinalWarps = 4;                      // 32-column groups per final block
constexpr int kDenseUnroll = 32;                    // final: part loads in flight, K <= 64
constexpr int kSparseUnroll = 16;                   // final: part loads in flight, K > 64

static_assert(kTileRows * 4 == kThreads, "|x|^2 takes four threads a row");

struct Params {
  const float* flat;      // (M, D)
  const float* embed;     // (K, D)
  int M, K, D;
  int tiles;              // ceil(M / kTileRows)
  int splits;             // code splits (grid.y of the assign kernel)
  int chunks_per_split;   // chunks per split
  int slots;              // min(kTileRows, K): slot capacity of a tile
  int vec;                // 16-byte copies allowed
  int* idx;               // (M,)
  float* counts;          // (K,)
  float* embed_sum;       // (K, D)
  float* win_val;         // (splits, M), only when splits > 1
  int* win_idx;           // (splits, M), only when splits > 1
  int* slot_tab;          // (tiles, K), only when K > kTileRows
  int* pcnt;              // (tiles, slots)
  float* part;            // (tiles, slots, D)
};

__host__ __device__ inline int padded_dim(int D) {
  return (D + kPadDims - 1) / kPadDims * kPadDims;
}
// x tile pitch: 4 mod 32 floats, 16-byte aligned rows
__host__ __device__ inline int x_pitch(int D) { return padded_dim(D) + 4; }

// Shared memory: [xs: tile][x2s][e2s][ints: 5 x kTileRows][ring of stages].
// The merge kernel uses everything before the ring.
__host__ __device__ inline size_t tile_smem_floats(int D) {
  return (size_t)kTileRows * x_pitch(D) + kTileRows + kMaxChunkCodes + 5 * kTileRows;
}

// Is (a, ia) preferred over (b, ib)? argmax order: NaN above every number,
// the lower index on ties; an index < 0 marks "nothing yet".
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Start the async copy of rows [row0, row0 + kTileRows) into xs; rows past M and
// columns past D are zero.
__device__ __forceinline__ void load_x_tile(const Params& p, float* xs, int row0) {
  const int D = p.D, xp = x_pitch(D), tid = threadIdx.x;
  if (p.vec) {
    const int q = D / 4;
    for (int i = tid; i < kTileRows * q; i += kThreads) {
      const int r = i / q, c = (i - r * q) * 4;
      float* dst = xs + r * xp + c;
      if (row0 + r < p.M) cp_async16(dst, p.flat + (size_t)(row0 + r) * D + c);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < kTileRows * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      float* dst = xs + r * xp + c;
      if (row0 + r < p.M) cp_async4(dst, p.flat + (size_t)(row0 + r) * D + c);
      else *dst = 0.f;
    }
  }
  const int pad = padded_dim(D) - D;
  for (int i = tid; i < kTileRows * pad; i += kThreads) {
    const int r = i / pad;
    xs[r * xp + D + (i - r * pad)] = 0.f;
  }
}

// Start the async copy of codes [k0, k0 + KC) x dims [d0, d0 + SD) into one ring
// stage (rows SD + 4 floats apart); codes past K and dims past D are zero.
template <int KC, int SD>
__device__ __forceinline__ void load_e_slice(const Params& p, float* es, int k0, int d0) {
  const int tid = threadIdx.x;
  if (p.vec) {
    for (int i = tid; i < KC * (SD / 4); i += kThreads) {
      const int c = i / (SD / 4), q = (i % (SD / 4)) * 4;
      const int k = k0 + c, d = d0 + q;
      float* dst = es + c * (SD + 4) + q;
      if (k < p.K && d < p.D) cp_async16(dst, p.embed + (size_t)k * p.D + d);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < KC * SD; i += kThreads) {
      const int c = i / SD, q = i % SD;
      const int k = k0 + c, d = d0 + q;
      float* dst = es + c * (SD + 4) + q;
      if (k < p.K && d < p.D) cp_async4(dst, p.embed + (size_t)k * p.D + d);
      else *dst = 0.f;
    }
  }
}

// The statistics of one tile whose rows' codes are in ridx (smem; -1 past
// M) and whose x is in xs (smem). Writes idx for the tile's rows and the
// tile's partial sums and counts. With K <= kTileRows the slots are the codes
// (dense: absent codes get zeros); otherwise slots are numbered by first
// appearance and slot_tab maps codes to them. Each partial sum adds its rows
// in row order.
__device__ __forceinline__ void tile_stats(const Params& p, const float* xs, int* ints, int tile) {
  int* ridx = ints;
  int* firstrow = ints + kTileRows;
  int* rowlist = ints + 2 * kTileRows;
  int* slot_start = ints + 3 * kTileRows;
  int* slot_n = ints + 4 * kTileRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int K = p.K, D = p.D, xp = x_pitch(D);
  const int row0 = tile * kTileRows, nrows = min(kTileRows, p.M - row0);
  const bool dense = K <= kTileRows;
  int* tab = dense ? nullptr : p.slot_tab + (size_t)tile * K;
  if (dense) {
    if (tid < K) slot_n[tid] = 0;
  } else {
    for (int k = tid; k < K; k += kThreads) tab[k] = -1;
  }

  // for each row: the first row with its code, its rank among those rows, and their count
  int code = -1, first = kTileRows, pos = 0, cnt = 0;
  if (tid < nrows) {
    code = ridx[tid];
    first = tid;
#pragma unroll 16
    for (int r = 0; r < kTileRows; ++r) {
      const bool same = ridx[r] == code;
      first = same && r < first ? r : first;
      pos += same && r < tid;
      cnt += same;
    }
    p.idx[row0 + tid] = code;
  }
  if (tid < kTileRows) firstrow[tid] = first;
  __syncthreads();  // firstrow is complete; the slot_n / slot_tab fill precedes the slots

  if (tid < nrows) {
    // rows of earlier slots come first in rowlist; slots by first appearance
    int start = 0, rank = 0;
#pragma unroll 16
    for (int r = 0; r < kTileRows; ++r) {
      const int f = firstrow[r];
      start += f < first;
      rank += f == r && r < first;
    }
    rowlist[start + pos] = tid;
    if (first == tid) {
      const int slot = dense ? code : rank;
      slot_start[slot] = start;
      slot_n[slot] = cnt;
      if (!dense) tab[code] = slot;
    }
  }
  const int nslots = __syncthreads_count(tid < nrows && first == tid);
  const int nout = dense ? K : nslots;
  if (tid < nout) p.pcnt[(size_t)tile * p.slots + tid] = slot_n[tid];

  // one warp a slot, lane + 32 u its columns; four rows' loads in flight
  float* part = p.part + (size_t)tile * p.slots * D;
  for (int s = warp; s < nout; s += kThreads / 32) {
    const int n = slot_n[s];
    const int* rows = rowlist + (n > 0 ? slot_start[s] : 0);
    float acc[kMaxDim / 32];
#pragma unroll
    for (int u = 0; u < kMaxDim / 32; ++u) acc[u] = 0.f;
    for (int j = 0; j < n; j += 4) {
      int r[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) r[v] = j + v < n ? rows[j + v] : -1;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (r[v] < 0) break;  // the same on every lane
#pragma unroll
        for (int u = 0; u < kMaxDim / 32; ++u)
          if (lane + 32 * u < D) acc[u] += xs[r[v] * xp + lane + 32 * u];
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxDim / 32; ++u)
      if (lane + 32 * u < D) part[(size_t)s * D + lane + 32 * u] = acc[u];
  }
}

// The assign kernel's tiling: chunks of KC codes, ring slices of SD dims,
// CG threads along codes (neighbouring lanes) and kThreads / CG along rows.
template <int KC_, int CG_, int SD_>
struct Tiling {
  static constexpr int KC = KC_, CG = CG_, SD = SD_;
  static constexpr int kSlicePitch = SD + 4;          // 4 mod 32: float4 reads hit distinct banks
  static constexpr int kStageFloats = KC * kSlicePitch;
  static constexpr int kRowGroups = kThreads / CG;
  static constexpr int kRowsPerThread = kTileRows / kRowGroups;
  static constexpr int kCodesPerThread = KC / CG;
  static constexpr int kE2Threads = kThreads / KC;   // threads summing one code's |e|^2
  static constexpr int kE2Dims = SD / kE2Threads;    // dims of a slice each sums
  static_assert(CG <= 32 && 32 % CG == 0 && KC % CG == 0 && KC <= kMaxChunkCodes, "codes");
  static_assert(kTileRows % kRowGroups == 0 && kPadDims % SD == 0, "rows, dims");
  static_assert(kE2Dims % 4 == 0 && kE2Threads <= 32, "|e|^2 in whole float4s within a warp");
};
using SmallK = Tiling<32, 16, 64>;   // K <= 32: 4 rows x 2 codes a thread
using LargeK = Tiling<128, 32, 32>;  // 8 rows x 4 codes; a warp reads one row group's x

// Grid (tiles, splits). Each block finds, for its 64 rows, the best code of
// its split's chunks of T::KC codes. With kFused (one split) it then writes
// the tile's statistics; otherwise it writes its winners to win_val/win_idx.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads, 2) assign_kernel(Params p) {
  constexpr int KC = T::KC, kSliceDims = T::SD, kSlicePitch = T::kSlicePitch;
  constexpr int kStageFloats = T::kStageFloats, kCodeGroups = T::CG;
  constexpr int kRowGroups = T::kRowGroups, kRowsPerThread = T::kRowsPerThread;
  constexpr int kCodesPerThread = T::kCodesPerThread;
  constexpr int kE2Threads = T::kE2Threads, kE2Dims = T::kE2Dims;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, K = p.K, xp = x_pitch(D), nslices = padded_dim(D) / kSliceDims;
  float* xs = smem;
  float* x2s = xs + kTileRows * xp;
  float* e2s = x2s + kTileRows;
  int* ints = reinterpret_cast<int*>(e2s + kMaxChunkCodes);
  float* ring = reinterpret_cast<float*>(ints + 5 * kTileRows);

  const int tid = threadIdx.x, tx = tid % kCodeGroups, ty = tid / kCodeGroups;
  const int tile = blockIdx.x, row0 = tile * kTileRows, split = blockIdx.y;
  const int chunks = (K + KC - 1) / KC;
  const int c_begin = split * p.chunks_per_split;
  const int c_end = min(chunks, c_begin + p.chunks_per_split);
  const int n = (c_end - c_begin) * nslices;  // ring stages of this block

  auto load_stage = [&](int s) {
    load_e_slice<KC, kSliceDims>(p, ring + (s % kStages) * kStageFloats,
                                 (c_begin + s / nslices) * KC, (s % nslices) * kSliceDims);
  };
  load_x_tile(p, xs, row0);
  for (int s = 0; s < kStages - 1; ++s) {  // group s holds stage s (group 0 also x)
    if (s < n) load_stage(s);
    cp_async_commit();
  }

  float acc[kRowsPerThread][kCodesPerThread];
  float best[kRowsPerThread];
  int best_k[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    best[i] = 0.f;
    best_k[i] = -1;
#pragma unroll
    for (int j = 0; j < kCodesPerThread; ++j) acc[i][j] = 0.f;
  }
  float e2part = 0.f;

  for (int s = 0; s < n; ++s) {
    cp_async_wait<kStages - 2>();  // stage s (and, at s = 0, the x tile) landed
    __syncthreads();               // ... for every thread; stage s - 1 is consumed
    if (s + kStages - 1 < n) load_stage(s + kStages - 1);
    cp_async_commit();             // an empty group keeps the count uniform

    if (s == 0) {  // |x|^2, four threads a row
      const int r = tid / 4, q = tid % 4;
      float v = 0.f;
      for (int d = 4 * q; d < padded_dim(D); d += 16) {
        const float4 a = ld4(xs + r * xp + d);
        v = fmaf(a.x, a.x, v);
        v = fmaf(a.y, a.y, v);
        v = fmaf(a.z, a.z, v);
        v = fmaf(a.w, a.w, v);
      }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) x2s[r] = v;
    }

    const int slice = s % nslices;
    const float* eb = ring + (s % kStages) * kStageFloats;
    const float* xb = xs + slice * kSliceDims;
#pragma unroll
    for (int dd = 0; dd < kSliceDims; dd += 4) {
      float4 xv[kRowsPerThread], ev[kCodesPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) xv[i] = ld4(xb + (ty + kRowGroups * i) * xp + dd);
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j)
        ev[j] = ld4(eb + (tx + kCodeGroups * j) * kSlicePitch + dd);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kCodesPerThread; ++j) {
          acc[i][j] = fmaf(xv[i].x, ev[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv[i].y, ev[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv[i].z, ev[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv[i].w, ev[j].w, acc[i][j]);
        }
      }
    }
    {  // |e|^2 of this slice: code tid / kE2Threads, kE2Dims of its dims
      const float* er = eb + (tid / kE2Threads) * kSlicePitch + kE2Dims * (tid % kE2Threads);
#pragma unroll
      for (int q = 0; q < kE2Dims; q += 4) {
        const float4 a = ld4(er + q);
        e2part = fmaf(a.x, a.x, e2part);
        e2part = fmaf(a.y, a.y, e2part);
        e2part = fmaf(a.z, a.z, e2part);
        e2part = fmaf(a.w, a.w, e2part);
      }
    }

    if (slice == nslices - 1) {  // the chunk's dot products are complete
#pragma unroll
      for (int off = 1; off < kE2Threads; off *= 2)
        e2part += __shfl_xor_sync(0xffffffffu, e2part, off);
      if (tid % kE2Threads == 0) e2s[tid / kE2Threads] = e2part;
      e2part = 0.f;
      __syncthreads();  // e2s (and x2s) are complete
      // A thread meets its codes in increasing order, so `better` reduces to:
      // take the first candidate, then a strictly larger value or the first
      // NaN, and nothing after a NaN.
      const int k0 = (c_begin + s / nslices) * KC;
      float x2[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) x2[i] = x2s[ty + kRowGroups * i];
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j) {
        const int c = tx + kCodeGroups * j, k = k0 + c;
        const float e2 = e2s[c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float dist = (2.f * acc[i][j] - x2[i]) - e2;
          if (k < K && (best_k[i] < 0 || (best[i] == best[i] && !(dist <= best[i])))) {
            best[i] = dist;
            best_k[i] = k;
          }
          acc[i][j] = 0.f;
        }
      }
    }
  }

  // the kCodeGroups threads of a row group are neighbouring lanes of one warp
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int off = kCodeGroups / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k[i], off);
      if (better(ov, ok, best[i], best_k[i])) {
        best[i] = ov;
        best_k[i] = ok;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + kRowGroups * i, m = row0 + r;
      if (kFused) {
        ints[r] = m < p.M ? best_k[i] : -1;
      } else if (m < p.M) {
        p.win_val[(size_t)split * p.M + m] = best[i];
        p.win_idx[(size_t)split * p.M + m] = best_k[i];
      }
    }
  }
  if (kFused) {
    __syncthreads();
    tile_stats(p, xs, ints, tile);
  }
}

// Grid (tiles). Folds the splits' winners in increasing split order, then
// writes the tile's statistics from x re-read into shared memory (from L2).
__global__ void __launch_bounds__(kThreads) merge_stats_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  int* ints = reinterpret_cast<int*>(xs + kTileRows * x_pitch(p.D) + kTileRows + kMaxChunkCodes);
  const int tid = threadIdx.x, tile = blockIdx.x, m = tile * kTileRows + tid;
  load_x_tile(p, xs, tile * kTileRows);
  cp_async_commit();
  if (tid < kTileRows && m >= p.M) ints[tid] = -1;
  if (tid < kTileRows && m < p.M) {
    float v = p.win_val[m];
    int k = p.win_idx[m];
    for (int s = 1; s < p.splits; ++s) {
      const float ov = p.win_val[(size_t)s * p.M + m];
      const int ok = p.win_idx[(size_t)s * p.M + m];
      if (better(ov, ok, v, k)) {
        v = ov;
        k = ok;
      }
    }
    ints[tid] = k;
  }
  cp_async_wait<0>();
  __syncthreads();
  tile_stats(p, xs, ints, tile);
}

// Grid (K, ceil(D / 128)). Block (k, y) owns code k; its warp w owns
// columns 128 y + 32 w + lane. It adds the code's partial sums over the tiles
// in increasing order, 32 (dense) or 16 (compact) loads in flight, and
// writes counts and embed_sum.
__global__ void __launch_bounds__(kFinalWarps * 32) final_kernel(Params p) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int k = blockIdx.x, d = blockIdx.y * 32 * kFinalWarps + 32 * warp + lane;
  if (d - lane >= p.D) return;  // the whole warp; warp 0 always stays
  const int K = p.K, D = p.D, slots = p.slots, tiles = p.tiles;
  const bool counter = blockIdx.y == 0 && warp == 0;
  float acc = 0.f;
  int cnt = 0;
  if (K <= kTileRows) {  // dense: slot = code in every tile
    for (int t0 = 0; t0 < tiles; t0 += kDenseUnroll) {
      float v[kDenseUnroll];
#pragma unroll
      for (int u = 0; u < kDenseUnroll; ++u)
        v[u] = t0 + u < tiles && d < D ? p.part[((size_t)(t0 + u) * K + k) * D + d] : 0.f;
#pragma unroll
      for (int u = 0; u < kDenseUnroll; ++u)
        if (t0 + u < tiles) acc += v[u];
    }
    if (counter)
      for (int t = lane; t < tiles; t += 32) cnt += p.pcnt[(size_t)t * K + k];
  } else {
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int t = t0 + lane;
      const int s = t < tiles ? p.slot_tab[(size_t)t * K + k] : -1;
      if (counter && s >= 0) cnt += p.pcnt[(size_t)t * slots + s];
      unsigned present = __ballot_sync(0xffffffffu, s >= 0);
      while (present) {  // the same on every lane
        float v[kSparseUnroll];
        int nv = 0;
#pragma unroll
        for (int u = 0; u < kSparseUnroll; ++u) {
          v[u] = 0.f;
          if (present) {
            const int src = __ffs(present) - 1;
            const int su = __shfl_sync(0xffffffffu, s, src);
            if (d < D) v[u] = p.part[((size_t)(t0 + src) * slots + su) * D + d];
            present &= present - 1;
            nv = u + 1;
          }
        }
#pragma unroll
        for (int u = 0; u < kSparseUnroll; ++u)
          if (u < nv) acc += v[u];
      }
    }
  }
  if (counter) {
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) p.counts[k] = (float)cnt;
  }
  if (d < D) p.embed_sum[(size_t)k * D + d] = acc;
}

template <typename F>
cudaError_t allow_smem(F* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch_assign(const Params& p, size_t tile_bytes, cudaStream_t st) {
  const size_t bytes = tile_bytes + sizeof(float) * kStages * T::kStageFloats;
  cudaError_t e;
  if (p.splits == 1) {
    if ((e = allow_smem(assign_kernel<T, true>, bytes)) != cudaSuccess) return e;
    assign_kernel<T, true><<<dim3(p.tiles, 1), kThreads, bytes, st>>>(p);
  } else {
    if ((e = allow_smem(assign_kernel<T, false>, bytes)) != cudaSuccess) return e;
    assign_kernel<T, false><<<dim3(p.tiles, p.splits), kThreads, bytes, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the kernels on `stream` and returns the first CUDA error as an
// int (0 on success). The caller checks 1 <= D <= 512, M >= 1 and K >= 1,
// allocates the outputs and the scratch (win_* only when splits > 1,
// slot_tab only when K > 64), and plans chunk_codes (32 or 64), splits and
// chunks_per_split.
extern "C" int vq_nearest_stats(const float* flat, const float* embed, int M, int K, int D,
                                int chunk_codes, int splits, int chunks_per_split, int* idx,
                                float* counts, float* embed_sum, float* win_val, int* win_idx,
                                int* slot_tab, int* pcnt, float* part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p{};
  p.flat = flat;
  p.embed = embed;
  p.M = M;
  p.K = K;
  p.D = D;
  p.tiles = (M + kTileRows - 1) / kTileRows;
  p.splits = splits;
  p.chunks_per_split = chunks_per_split;
  p.slots = K < kTileRows ? K : kTileRows;
  p.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(flat) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(embed) % 16 == 0;
  p.idx = idx;
  p.counts = counts;
  p.embed_sum = embed_sum;
  p.win_val = win_val;
  p.win_idx = win_idx;
  p.slot_tab = slot_tab;
  p.pcnt = pcnt;
  p.part = part;

  const size_t tile_bytes = sizeof(float) * tile_smem_floats(D);
  cudaError_t e;
  if (chunk_codes == SmallK::KC) e = launch_assign<SmallK>(p, tile_bytes, st);
  else if (chunk_codes == LargeK::KC) e = launch_assign<LargeK>(p, tile_bytes, st);
  else e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    if ((e = allow_smem(merge_stats_kernel, tile_bytes)) != cudaSuccess) return (int)e;
    merge_stats_kernel<<<p.tiles, kThreads, tile_bytes, st>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  final_kernel<<<dim3(K, (D + 32 * kFinalWarps - 1) / (32 * kFinalWarps)), kFinalWarps * 32, 0,
                 st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* vq_nearest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
