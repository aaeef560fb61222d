// Trajectory dynamic programs for the flyability distances: DTW, ERP, EDR,
// LCSS (planar degrees or great-circle metres) and the discrete Frechet.
//
// Replaces the JAX package's jnp row loops (there is no pallas_call on this
// path): dtw / erp / edr / lcss / discret_frechet in
// tvqvae_tpu/evaluation/flyability/distances.py:187-331, where each row of
// the DP is one lax.associative_scan, the rows run under lax.scan, and a
// bucket of flight pairs is vmapped with its (P, Q) cost matrix and about
// five more such buffers per pair in device memory.
//
// What bounds it on an H100. Every cell of every grid counts, and a cell
// waits on its left, upper and diagonal neighbours: a pair's n + m - 1
// anti-diagonals are a chain that no schedule shortens. A great-circle cost
// is two sinf, an asinf and a root, some 250 instructions whose libdevice
// slow-path branches keep even independent costs from overlapping inside a
// warp: a warp alone takes ~950 cycles a step over one spherical cell and
// its four recurrences, ~400 over a planar cell and the discrete Frechet.
// So the bucket of 2 long pairs is bound by its ~9,300-cell chain at that
// latency (its pipeline is ~15% longer than the chain), and the bucket of
// 64 short pairs, 19 strips to an SM, by the SMs' issue rate on the
// spherical tasks. The operations the bound counts (a transcendental as
// one) are 50-100x below either. The earlier design (one block a (pair,
// variant), one block-wide barrier a diagonal, the DP state in shared
// memory) paid each cost nine times over: four spherical and five planar
// blocks repeated the same costs, the bucket of 64 short pairs took three
// waves of blocks, and the bucket of 2 long pairs used 18 of the 132 SMs.
//
// Design.
//  - A task is a (pair, metric): the cost of a cell is computed once and fed
//    to every recurrence of that metric that the call asks for, each in its
//    own registers. The recurrences present are a template parameter (three
//    instances: the planar five, the discrete Frechet alone, the spherical
//    four; a subset of a metric runs the smallest instance that holds it and
//    stores only what was asked).
//  - The grid is walked with its shorter side across the lanes: "columns"
//    are the shorter side's points, "rows" the longer side's. Transposing
//    gives the same bits: min and max are exact, ERP's three terms only swap
//    places, and the cost is always evaluated with p's point first (a sign
//    on the halved difference does that for free).
//  - A warp owns a strip of 32 columns, one to a lane, and sweeps the rows in
//    a skewed pipeline: at step s lane t updates its cell of row s - t,
//    taking its left neighbour's cell from lane t - 1 with
//    __shfl_up_sync. The DP state (the previous row of each recurrence) stays
//    in registers; nothing is stored per cell and no block-wide barrier runs
//    per step. The costs of a chunk of kChunk rows are computed before its
//    steps, and cells outside the grid are computed and dropped rather than
//    branched around. (Two to four cells a lane, fewer strips to hand off,
//    measured 1.2-3.4x slower at both buckets of the flyability batch.)
//  - Consecutive strips hand their last column to the next strip through a
//    ring in the receiving warp's shared memory under release/acquire
//    counters (rows written, rows read): within a block every kChunk rows at
//    the block's scope; across blocks every kRemoteChunk rows at the
//    cluster's scope, which this card implements as a device-wide fence
//    (~1 us). A strip waits only when the strip on its left has not finished
//    a chunk yet, or when the ring is full.
//  - A task's strips fill the warps of one block or, where there are fewer
//    tasks than SMs, of a thread-block cluster of up to 16 blocks on as many
//    SMs; the ring then crosses blocks through distributed shared memory.
//    All blocks of a cluster are co-scheduled, so the waits cannot deadlock.
//    The plan (warps a block, blocks a cluster, the side the lanes run
//    along) is chosen in Python (ops/traj_dp_kernel.py), which reads the
//    limits below from this file.
//  - Each block first computes its task's per-point features and ERP gap
//    costs into shared memory; ERP's borders are the total gap sums, added
//    in the order of a block sum over `sum_threads` threads (strided, a warp
//    tree, then the warps in order), which every plan shares.
//
// Each cell is the textbook recurrence, which equals the JAX package's row
// form cell by cell (a row scan composes the same min/max/+ terms in another
// order, so DTW and ERP differ from it by rounding only; EDR and LCSS count
// in exact integers; the discrete Frechet only selects).
//
// Precision: float32 as in JAX. The costs use the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fsqrt_rn), which nvcc never
// contracts into FMAs, and IEEE sinf / cosf / asinf (no fast math), in the
// plain PyTorch version's operation order, so both compute the same costs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

// The limits and layout that ops/traj_dp_kernel.py reads from this file.
constexpr int kMaxThreads = 640;  // a block's threads (the register cap of __launch_bounds__)
constexpr int kMaxCluster = 16;   // blocks a cluster (non-portable above 8)
constexpr int kMaxTasks = 16;
constexpr int kKinds = 5;
enum Kind { kDTW = 0, kERP = 1, kEDR = 2, kLCSS = 3, kDiscreteFrechet = 4 };
// The instances: the set of recurrences a task runs.
enum TaskType { kPlanarAll = 0, kFrechetOnly = 1, kSphericalAll = 2 };
constexpr int kRing = 128;        // rows a strip's hand-off ring holds
constexpr int kChunk = 8;         // rows a hand-off counter covers within a block
constexpr int kRemoteChunk = 32;  // and across the blocks of a cluster
constexpr unsigned kFull = 0xffffffffu;

constexpr float kDegToRad = 0.017453292519943295f;  // float32(pi / 180), as jnp.radians
constexpr float kTwoR = 12756274.0f;                 // 2 * 6378137 m, exact in float32

struct Task {
  int type;
  int slot[kKinds];  // output column of each kind's variant, -1 if not asked
  float eps_edr, eps_lcss;
};

struct Tasks {
  Task t[kMaxTasks];
};

struct Args {
  const float *p, *q;
  const int *n, *m;
  int P, Q;
  int rows_cap, cols_cap;  // the longest rows and columns of the launch
  int swap;                // rows are q's points, columns p's
  int ntasks, V, warps, sum_threads;
  float g0, g1;
  float* out;
};

// Per-point features (x, y, z) and the ERP gap cost to g (w): planar (lat,
// lon, -); spherical (lat, lon in radians, cos lat).
template <bool SPH>
__device__ __forceinline__ float4 point_features(float lat, float lon) {
  if (SPH) {
    const float la = __fmul_rn(lat, kDegToRad);
    return make_float4(la, __fmul_rn(lon, kDegToRad), cosf(la), 0.f);
  }
  return make_float4(lat, lon, 0.f, 0.f);
}

// d(a, b) with a p's point and b q's (or a point and g): planar sqrt(d0^2 +
// d1^2 + 1e-30); spherical 2R asin(sqrt(clip(sin^2(dlat / 2) + (cos lat_a cos
// lat_b) sin^2(dlon / 2), 0, 1))). With `half` -0.5 it takes a as q's point
// and b as p's, to the same bits: (a - b) * -0.5 is (b - a) * 0.5 exactly,
// d0 and d1 are squared and the cosines' product commutes.
template <bool SPH>
__device__ __forceinline__ float point_dist(const float4& a, const float4& b, float half) {
  if (!SPH) {
    const float d0 = __fsub_rn(a.x, b.x), d1 = __fsub_rn(a.y, b.y);
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), 1e-30f));
  }
  const float s0 = sinf(__fmul_rn(__fsub_rn(b.x, a.x), half));
  const float s1 = sinf(__fmul_rn(__fsub_rn(b.y, a.y), half));
  float s = __fadd_rn(__fmul_rn(s0, s0), __fmul_rn(__fmul_rn(a.z, b.z), __fmul_rn(s1, s1)));
  s = fminf(fmaxf(s, 0.f), 1.f);
  return __fmul_rn(kTwoR, asinf(__fsqrt_rn(s)));
}

// The sum of x[0..count).w in the order of a block sum over T threads:
// thread t adds x[t], x[t + T], ...; each warp of 32 such threads folds by
// __shfl_down_sync (16, 8, 4, 2, 1); the warps' sums are added in order.
// One warp runs it, lane l standing for thread 32 w + l of each warp w.
__device__ float ordered_sum(const float4* x, int count, int T, int lane) {
  float total = 0.f;
  for (int w = 0; w < T / 32; ++w) {
    float s = 0.f;
    for (int k = 32 * w + lane; k < count; k += T) s = __fadd_rn(s, x[k].w);
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
    total = __fadd_rn(total, s);
  }
  return __shfl_sync(kFull, total, 0);
}

// The hand-off counters: a release store and an acquire load, at the
// cluster's scope where the two warps sit in different blocks, else at the
// block's.
__device__ __forceinline__ void store_release(unsigned* p, unsigned v, bool cluster) {
  if (cluster) {
    asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.release.cta.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p, bool cluster) {
  unsigned v;
  if (cluster) {
    asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

__device__ __forceinline__ void wait_at_least(const unsigned* counter, int need, bool cluster) {
  while ((int)load_acquire(counter, cluster) < need) __nanosleep(64);
}

// One task: the cluster's blocks hold its strips in order, `warps` to a block.
template <bool SPH, int MASK>
__device__ void run_task(const Args& a, const Task& tk, int b, float4* smem) {
  constexpr bool DTW = MASK & (1 << kDTW), ERP = MASK & (1 << kERP), EDR = MASK & (1 << kEDR),
                 LCSS = MASK & (1 << kLCSS), DF = MASK & (1 << kDiscreteFrechet);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int W = a.warps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n[b], m = a.m[b];
  const bool swap = a.swap != 0;
  const int R = swap ? m : n, C = swap ? n : m;
  const float* pb = a.p + (size_t)b * a.P * 2;
  const float* qb = a.q + (size_t)b * a.Q * 2;
  const float* rowp = swap ? qb : pb;
  const float* colp = swap ? pb : qb;

  float4* rowf = smem;                                     // rows_cap
  float4* colf = rowf + a.rows_cap;                        // cols_cap
  float* ring = reinterpret_cast<float*>(colf + a.cols_cap);  // [W][kRing][kKinds]
  unsigned* done = reinterpret_cast<unsigned*>(ring + W * kRing * kKinds);  // [W] rows written in
  unsigned* used = done + W;  // [W] rows the strip on this warp's right has read
  float* sums = reinterpret_cast<float*>(used + W);        // ERP: p's gaps, q's gaps

  const float4 gf = point_features<SPH>(a.g0, a.g1);
  for (int i = tid; i < R; i += blockDim.x) {
    float4 f = point_features<SPH>(rowp[2 * i], rowp[2 * i + 1]);
    if (ERP) f.w = point_dist<SPH>(f, gf, 0.5f);
    rowf[i] = f;
  }
  for (int j = tid; j < C; j += blockDim.x) {
    float4 f = point_features<SPH>(colp[2 * j], colp[2 * j + 1]);
    if (ERP) f.w = point_dist<SPH>(f, gf, 0.5f);
    colf[j] = f;
  }
  if (tid < W) {
    done[tid] = 0u;
    used[tid] = 0u;
  }
  __syncthreads();
  if (ERP && warp == 0) {
    const float sp = ordered_sum(swap ? colf : rowf, n, a.sum_threads, lane);
    const float sq = ordered_sum(swap ? rowf : colf, m, a.sum_threads, lane);
    if (lane == 0) {
      sums[0] = sp;
      sums[1] = sq;
    }
  }
  cluster.sync();  // every counter of the cluster is zero before any strip runs

  const int strip = rank * W + warp;
  if (strip * 32 < C) {
    const bool has_left = strip > 0, has_right = (strip + 1) * 32 < C;
    const int col = strip * 32 + lane;
    // this warp's ring and counters, and its neighbours'
    const float* ring_in = ring + warp * kRing * kKinds;
    const unsigned* done_in = done + warp;
    const unsigned* used_in = used + warp;
    float* ring_out = nullptr;
    unsigned *done_out = nullptr, *used_back = nullptr;
    if (has_right) {
      const int r = (strip + 1) / W, w = (strip + 1) % W;
      ring_out = cluster.map_shared_rank(ring + w * kRing * kKinds, r);
      done_out = cluster.map_shared_rank(done + w, r);
    }
    if (has_left) {
      const int r = (strip - 1) / W, w = (strip - 1) % W;
      used_back = cluster.map_shared_rank(used + w, r);
    }

    const float erp_rows = ERP ? (swap ? sums[1] : sums[0]) : 0.f;  // the row points' gaps
    const float erp_cols = ERP ? (swap ? sums[0] : sums[1]) : 0.f;
    // borders of the augmented grid: top D[0][j > 0], left D[i > 0][0], corner 0
    float top[kKinds], left[kKinds];
    top[kDTW] = left[kDTW] = INFINITY;
    top[kERP] = erp_cols;
    left[kERP] = erp_rows;
    top[kEDR] = left[kEDR] = top[kLCSS] = left[kLCSS] = 0.f;
    top[kDiscreteFrechet] = left[kDiscreteFrechet] = INFINITY;

    const float4 cf = colf[min(col, C - 1)];
    float st[kKinds];   // D[r - 1][col], then D[r][col]
    float dgp[kKinds];  // D[r - 1][col - 1]
#pragma unroll
    for (int v = 0; v < kKinds; ++v) {
      st[v] = top[v];
      dgp[v] = col == 0 ? 0.f : top[v];
    }
    const float half = swap ? -0.5f : 0.5f;  // the row point is q's when swapped
    const float eps_edr = tk.eps_edr, eps_lcss = tk.eps_lcss;
    // a hand-off within the block orders at the block's scope, every kChunk
    // rows; across blocks at the cluster's (a device-wide fence), every
    // kRemoteChunk rows
    const bool right_remote = has_right && (strip + 1) / W != rank;
    const bool left_remote = has_left && (strip - 1) / W != rank;
    const int chunk_in = left_remote ? kRemoteChunk : kChunk;
    const int chunk_out = right_remote ? kRemoteChunk : kChunk;

    const int steps = R + 31;  // lane t walks row s - t at step s
    for (int s0 = 0; s0 < steps; s0 += kChunk) {
      // the chunk's costs first: kChunk evaluations that do not wait on the
      // recurrences
      float cc[kChunk], rgap[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4 rf = rowf[min(max(s0 + i - lane, 0), R - 1)];
        rgap[i] = rf.w;
        cc[i] = point_dist<SPH>(rf, cf, half);
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int s = s0 + i;
        if (s >= steps) break;
        const int r = s - lane;
        if (i == 0 && has_left && s < R && (s & (chunk_in - 1)) == 0) {
          // rows [s, s + chunk_in) from the left strip
          if (lane == 0) wait_at_least(done_in, min(R, s + chunk_in), left_remote);
          __syncwarp();
        }
        const int r31 = s - 31;  // the row lane 31 hands on at this step
        if (has_right && r31 >= 0 && r31 < R && (r31 & (chunk_out - 1)) == 0) {
          if (lane == 31) wait_at_least(used_in, r31 + chunk_out - kRing, right_remote);
          __syncwarp();
        }
        float lf[kKinds];  // D[r][col - 1]
#pragma unroll
        for (int v = 0; v < kKinds; ++v) {
          if (MASK & (1 << v)) {
            lf[v] = __shfl_up_sync(kFull, st[v], 1);
            if (lane == 0) lf[v] = has_left ? ring_in[(r & (kRing - 1)) * kKinds + v] : left[v];
          }
        }
        // cells outside the grid are computed and dropped, without a branch
        const bool live = r >= 0 && r < R && col < C;
        const float c = cc[i], grow = rgap[i];
        float dg[kKinds];
#pragma unroll
        for (int v = 0; v < kKinds; ++v) {
          dg[v] = dgp[v];
          dgp[v] = live ? lf[v] : dgp[v];
        }
        if (DTW) {
          const float x = __fadd_rn(c, fminf(fminf(st[kDTW], dg[kDTW]), lf[kDTW]));
          st[kDTW] = live ? x : st[kDTW];
        }
        if (ERP) {
          const float x = fminf(fminf(__fadd_rn(dg[kERP], c), __fadd_rn(st[kERP], grow)),
                                __fadd_rn(lf[kERP], cf.w));
          st[kERP] = live ? x : st[kERP];
        }
        if (EDR) {
          const float x = fminf(fminf(dg[kEDR] + (c >= eps_edr ? 1.f : 0.f), st[kEDR] + 1.f),
                                lf[kEDR] + 1.f);
          st[kEDR] = live ? x : st[kEDR];
        }
        if (LCSS) {
          const float x =
              fmaxf(fmaxf(dg[kLCSS] + (c < eps_lcss ? 1.f : 0.f), st[kLCSS]), lf[kLCSS]);
          st[kLCSS] = live ? x : st[kLCSS];
        }
        if (DF) {
          const float x = fmaxf(
              c, fminf(fminf(st[kDiscreteFrechet], dg[kDiscreteFrechet]), lf[kDiscreteFrechet]));
          st[kDiscreteFrechet] = live ? x : st[kDiscreteFrechet];
        }
        if (has_right && lane == 31 && r31 >= 0 && r31 < R) {  // hand row r31's cell on
          float* slot = ring_out + (r31 & (kRing - 1)) * kKinds;
#pragma unroll
          for (int v = 0; v < kKinds; ++v) {
            if (MASK & (1 << v)) slot[v] = st[v];
          }
          if (((r31 + 1) & (chunk_out - 1)) == 0 || r31 == R - 1) {
            store_release(done_out, r31 + 1, right_remote);
          }
        }
        if (has_left && lane == 0 && s < R && (((s + 1) & (chunk_in - 1)) == 0 || s == R - 1)) {
          store_release(used_back, s + 1, left_remote);  // rows read from the left strip's ring
        }
      }
    }

    // D[n][m]: the lane that holds the true corner kept it since row R - 1
    if (col == C - 1) {
      float* out = a.out + (size_t)b * a.V;
      if (DTW && tk.slot[kDTW] >= 0) out[tk.slot[kDTW]] = st[kDTW];
      if (ERP && tk.slot[kERP] >= 0) out[tk.slot[kERP]] = st[kERP];
      if (EDR && tk.slot[kEDR] >= 0) out[tk.slot[kEDR]] = __fdiv_rn(st[kEDR], (float)max(n, m));
      if (LCSS && tk.slot[kLCSS] >= 0) {
        out[tk.slot[kLCSS]] = __fsub_rn(1.f, __fdiv_rn(st[kLCSS], (float)min(n, m)));
      }
      if (DF && tk.slot[kDiscreteFrechet] >= 0) {
        out[tk.slot[kDiscreteFrechet]] = st[kDiscreteFrechet];
      }
    }
  }
  cluster.sync();  // no block leaves while a neighbour may still write its shared memory
}

// One launch: blocks (pair, task, rank in the task's cluster), pair-major.
__global__ void __launch_bounds__(kMaxThreads) traj_dp_kernel(Args a, Tasks tasks) {
  extern __shared__ float4 smem[];
  const int task = blockIdx.x / cg::this_cluster().num_blocks();
  const int b = task / a.ntasks;
  const Task tk = tasks.t[task % a.ntasks];
  switch (tk.type) {
    case kPlanarAll:
      run_task<false, 31>(a, tk, b, smem);
      break;
    case kFrechetOnly:
      run_task<false, 1 << kDiscreteFrechet>(a, tk, b, smem);
      break;
    default:  // kSphericalAll
      run_task<true, 15>(a, tk, b, smem);
  }
}

// Dynamic shared memory of a block (ops/traj_dp_kernel.py::smem_bytes).
size_t smem_bytes(int rows_cap, int cols_cap, int warps) {
  return sizeof(float4) * (rows_cap + cols_cap) + sizeof(float) * warps * kRing * kKinds +
         2 * sizeof(unsigned) * warps + 2 * sizeof(float);
}

cudaError_t prepare(int cluster, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(traj_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(traj_dp_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

cudaLaunchConfig_t config(int blocks, int warps, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

const char* traj_dp_error_string(int err) {
  if (err == -1) return "warps or cluster outside the kernel's limits";
  if (err == -2) return "more than 16 tasks a pair";
  if (err == -3) {
    return "shared memory does not match the plan (smem_bytes in traj_dp.cu and "
           "ops/traj_dp_kernel.py differ)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// p (B, P, 2), q (B, Q, 2) float32 on the device; n, m (B,) int32 true
// lengths on the device; rows_cap, cols_cap the longest rows and columns
// (q's and p's points when `swap`, else p's and q's); g the gap point;
// sum_threads the block size whose order ERP's border sums take; ntasks
// tasks a pair: types, slots (ntasks x 5: each kind's output column or -1)
// and eps (ntasks x 2: EDR's, LCSS's); out (B, V) float32. The plan: warps
// a block, cluster blocks a task, smem_bytes the dynamic shared memory a
// block. Returns a cudaError_t (0 on success) or a negative code of
// traj_dp_error_string.
int traj_dp(const float* p, const float* q, const int* n, const int* m, int B, int P, int Q,
            int rows_cap, int cols_cap, int swap, float g0, float g1, int sum_threads, int ntasks,
            const int* types, const int* slots, const float* eps, int V, int warps, int cluster,
            int smem, float* out, void* stream) {
  if (warps < 1 || 32 * warps > kMaxThreads || cluster < 1 || cluster > kMaxCluster) return -1;
  if (ntasks < 1 || ntasks > kMaxTasks) return -2;
  if ((size_t)smem != smem_bytes(rows_cap, cols_cap, warps)) return -3;
  Tasks t = {};
  for (int i = 0; i < ntasks; ++i) {
    t.t[i].type = types[i];
    for (int v = 0; v < kKinds; ++v) t.t[i].slot[v] = slots[kKinds * i + v];
    t.t[i].eps_edr = eps[2 * i];
    t.t[i].eps_lcss = eps[2 * i + 1];
  }
  const Args a{p,        q,        n,     m,    P,     Q,           rows_cap, cols_cap, swap,
               ntasks,   V,        warps, sum_threads, g0, g1,      out};
  cudaError_t err = prepare(cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(B * ntasks * cluster, warps, smem,
                                        static_cast<cudaStream_t>(stream), &attr, cluster);
  err = cudaLaunchKernelEx(&cfg, traj_dp_kernel, a, t);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Blocks of the plan that one SM holds, and clusters the card holds at once.
int traj_dp_occupancy(int warps, int cluster, int smem, int* blocks, int* clusters) {
  cudaError_t err = prepare(cluster, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, traj_dp_kernel, 32 * warps, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(cluster, warps, smem, nullptr, &attr, cluster);
  return cudaOccupancyMaxActiveClusters(clusters, traj_dp_kernel, &cfg);
}

}  // extern "C"
