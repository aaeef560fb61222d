// Continuous Frechet distance: the 30 bisection steps over the Alt-Godau
// free-space decision, run as rounds of speculative bisection.
//
// Replaces the JAX package's jnp code (there is no pallas_call on this
// path): frechet_jax and _frechet_decision_jax in
// tvqvae_tpu/evaluation/flyability/distances.py:378-524. JAX runs the 30
// steps as a fori_loop, each decision as a lax.scan over p's segments whose
// in-row propagation is one lax.associative_scan of five-tuple maps
// (r, c, A, C, F), vmapped over a bucket of pairs.
//
// Design. Given the bracket (lo, hi), the midpoints of the next `levels`
// levels of the bisection tree are known in advance: node v of the heap
// (root 1, children 2v when the decision holds, 2v+1 when it does not) has
// the bracket that the sequential steps would reach along its path, and its
// midpoint is the same float32 expression 0.5 * (lo + hi). One launch is one
// round: every one of the 2^levels - 1 candidate midpoints of every pair is
// decided at once, K candidates to a thread block, and the pair's last block
// to finish walks the tree down its decisions to the next (lo, hi). The
// decision is deterministic, so after ceil(30 / depth) rounds the result
// equals 30 sequential steps bit for bit; the extra decisions run on SMs that
// the one block of a pair would leave idle. Rounds chain through device
// memory (the bracket, the decision bits and a counter a pair), with no host
// sync between them; the first round starts from lo = max(endpoint
// distances) and the discrete Frechet as hi, the last writes out.
//
// A decision is the free-space reachability DP over the cells (i, j) of the
// true n x m grid: R_V(i, j+1) and R_H(i+1, j) follow from R_V(i, j) and
// R_H(i, j) by max, min and comparisons only. JAX composes each row's maps
// with an associative scan; every such step is exact, so walking the row in
// order gives the same values. The block runs that walk as a wavefront: each
// thread owns CHUNK consecutive columns and keeps, in registers, the
// reachable lo of the bottom edges below them; at step s thread t walks its
// chunk of row i = s - t, entering with the R_V(i, j) that thread t - 1 left
// at step s - 1 (a shuffle inside a warp, shared memory between warps, one
// barrier a step). A round is n - 1 + threads - 1 steps, each as long as one
// thread's chunk, where a block-wide scan of every row cost ten dependent
// shuffle levels and a barrier.
//
// Only reachable cells cost arithmetic. A cell whose entering R_V and R_H
// are empty at every candidate leaves both exits empty whatever its free
// intervals, so its divisions and roots are skipped, exactly. The reachable
// region of two similar tracks is a band a few warps wide along the grid's
// diagonal, so most warps only pass the wavefront on.
//
// What does not depend on eps is computed once. A free interval of segment
// a->b and centre c needs d = b - a, dd, w = c - a, w.w and t0 = (w.d) / dd;
// only disc = (e2 - w.w) / dd + t0^2 and its root change with eps. A block
// computes those terms once per cell for its K candidates. The boundaries are
// computed once per decision: the bottom row's reachable prefix, and the left
// column's as one index per candidate (R_V(i, 0) is 0 up to it and empty
// after), which no thread recomputes in the step loop.
//
// Arithmetic: float32 with the round-to-nearest intrinsics, which nvcc never
// contracts into FMAs, in the plain PyTorch version's operation order.
//
// What bounds it on an H100: the chain of rounds x (n - 1 + threads - 1)
// dependent steps, each as long as one thread's chunk of reachable cells
// (their divisions and roots wait on each other) and a barrier. Dividing and
// rooting without the intrinsics' slow-path branches, exactly, was measured
// slower; so was computing every cell.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sq_dist(float ax, float ay, float bx, float by) {
  const float d0 = __fsub_rn(ax, bx), d1 = __fsub_rn(ay, by);
  return __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// Segment a->b: d = b - a and dd clamped below, for the free intervals of
// every centre (distances.py:378-400).
struct Seg {
  float ax, ay, d0, d1, ddc;
  bool pos;  // dd > 0
};

__device__ __forceinline__ Seg segment(float ax, float ay, float bx, float by) {
  Seg s;
  s.ax = ax;
  s.ay = ay;
  s.d0 = __fsub_rn(bx, ax);
  s.d1 = __fsub_rn(by, ay);
  const float dd = __fadd_rn(__fmul_rn(s.d0, s.d0), __fmul_rn(s.d1, s.d1));
  s.ddc = fmaxf(dd, 1e-30f);
  s.pos = dd > 0.f;
  return s;
}

// The eps-invariant terms of one free interval: w = c - a, w.w, t0, t0^2.
struct Cell {
  float ww, t0, t0sq;
};

__device__ __forceinline__ Cell cell(const Seg& s, float cx, float cy) {
  const float w0 = __fsub_rn(cx, s.ax), w1 = __fsub_rn(cy, s.ay);
  Cell c;
  c.ww = __fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1));
  c.t0 = s.pos ? __fdiv_rn(__fadd_rn(__fmul_rn(w0, s.d0), __fmul_rn(w1, s.d1)), s.ddc) : 0.f;
  c.t0sq = __fmul_rn(c.t0, c.t0);
  return c;
}

// Free interval [lo, hi] within the e2 = eps^2 ball; empty as lo = 1 > hi = -1.
__device__ __forceinline__ void interval(const Seg& s, const Cell& c, float e2, float& lo,
                                         float& hi) {
  const float disc =
      s.pos ? __fadd_rn(__fdiv_rn(__fsub_rn(e2, c.ww), s.ddc), c.t0sq) : (c.ww <= e2 ? 1.f : -1.f);
  if (disc >= 0.f) {
    const float r = __fsqrt_rn(disc);
    lo = fmaxf(__fsub_rn(c.t0, r), 0.f);
    hi = fminf(__fadd_rn(c.t0, r), 1.f);
  } else {
    lo = 1.f;
    hi = -1.f;
  }
}

// One round for K candidates of one pair: grid = B * ceil((2^levels - 1) / K)
// blocks, pair-major.
template <int CHUNK, int K>
__global__ void __launch_bounds__(1024) frechet_kernel(
    const float* __restrict__ p, const float* __restrict__ q, const int* __restrict__ n_arr,
    const int* __restrict__ m_arr, const float* __restrict__ hi_in, int P, int Q, int levels,
    int first, int last, float* lo_state, float* hi_state, int* ok_bits, int ok_stride,
    unsigned* done, float* __restrict__ out, unsigned long long* cells) {
  __shared__ float handoff[2][K][32];  // R_V leaving each warp, by step parity
  __shared__ int bottom_first[K], left_first[K], decided[K];

  const int ncand = (1 << levels) - 1;
  const int groups = (ncand + K - 1) / K;
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;
  const int n = n_arr[b], m = m_arr[b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pb = p + (size_t)b * P * 2;
  const float* qb = q + (size_t)b * Q * 2;
  if (tid < K) {
    bottom_first[tid] = m - 1;
    left_first[tid] = n - 1;
    decided[tid] = 0;
  }
  __syncthreads();

  const float p0x = __ldg(pb), p0y = __ldg(pb + 1);
  const float q0x = __ldg(qb), q0y = __ldg(qb + 1);
  const float start2 = sq_dist(p0x, p0y, q0x, q0y);
  const float end2 = sq_dist(__ldg(pb + 2 * n - 2), __ldg(pb + 2 * n - 1), __ldg(qb + 2 * m - 2),
                             __ldg(qb + 2 * m - 1));
  float lo, hi;  // the bracket at the round's start
  if (first) {
    lo = fmaxf(__fsqrt_rn(start2), __fsqrt_rn(end2));
    hi = hi_in[b];
  } else {
    lo = lo_state[b];
    hi = hi_state[b];
  }

  // this block's candidates: heap nodes v = g * K + k + 1
  float e2[K];
  bool live[K];
  bool any_live = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = g * K + k;
    const int v = c < ncand ? c + 1 : 1;
    float l = lo, h = hi;
    for (int s = 30 - __clz(v); s >= 0; --s) {  // the path below the root
      const float mid = midpoint(l, h);
      if ((v >> s) & 1) {
        l = mid;
      } else {
        h = mid;
      }
    }
    const float eps = midpoint(l, h);
    e2[k] = __fmul_rn(eps, eps);
    live[k] = c < ncand && start2 <= e2[k] && end2 <= e2[k];
    any_live = any_live || live[k];
  }

  const int elems = m - 1;  // vertical edges V(i, j+1) / bottom edges j of a row
  const int j0 = tid * CHUNK;
  bool reach[K];
#pragma unroll
  for (int k = 0; k < K; ++k) reach[k] = false;
  unsigned reached = 0;  // cells this thread finds reached, counted with `cells` at K = 1

  if (any_live) {  // uniform across the block
    float qx[CHUNK + 1], qy[CHUNK + 1];  // this thread's columns' points
#pragma unroll
    for (int c = 0; c <= CHUNK; ++c) {
      const int j = min(j0 + c, m - 1);
      qx[c] = __ldg(qb + 2 * j);
      qy[c] = __ldg(qb + 2 * j + 1);
    }
    // bottom boundary R_H(0, j): reachable while every earlier edge is full
    float blo[K][CHUNK], bhi[K][CHUNK], bot[K][CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int j = j0 + c;
      if (j < elems) {
        const Seg s = segment(qx[c], qy[c], qx[c + 1], qy[c + 1]);
        const Cell w = cell(s, p0x, p0y);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          interval(s, w, e2[k], blo[k][c], bhi[k][c]);
          if (!(blo[k][c] <= 0.f && bhi[k][c] >= 1.f)) atomicMin(&bottom_first[k], j);
        }
      }
    }
    // left boundary R_V(i, 0): the same rule up the rows
    for (int i = tid; i + 1 < n; i += blockDim.x) {
      const Seg s = segment(__ldg(pb + 2 * i), __ldg(pb + 2 * i + 1), __ldg(pb + 2 * i + 2),
                            __ldg(pb + 2 * i + 3));
      const Cell w = cell(s, q0x, q0y);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float vlo, vhi;
        interval(s, w, e2[k], vlo, vhi);
        if (!(vlo <= 0.f && vhi >= 1.f)) atomicMin(&left_first[k], i);
      }
    }
    __syncthreads();
    int left_reach[K];  // R_V(i, 0) = 0 for i <= left_reach, empty after (thread 0 reads it)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int first_bot = bottom_first[k];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int j = j0 + c;
        bot[k][c] = INFINITY;
        if (j < elems) {
          const float x = (j <= first_bot && blo[k][c] <= 0.f) ? 0.f : INFINITY;
          bot[k][c] = x <= bhi[k][c] ? x : INFINITY;
        }
      }
      const int f = left_first[k];
      left_reach[k] = f - 1;
      if (tid == 0 && f + 1 < n) {  // the first edge that is not full may still hold 0
        const Seg s = segment(__ldg(pb + 2 * f), __ldg(pb + 2 * f + 1), __ldg(pb + 2 * f + 2),
                              __ldg(pb + 2 * f + 3));
        float vlo, vhi;
        interval(s, cell(s, q0x, q0y), e2[k], vlo, vhi);
        if (vlo <= 0.f && 0.f <= vhi) left_reach[k] = f;
      }
    }

    // The wavefront: at step s thread t walks its chunk of row i = s - t,
    // entering with R_V(i, j0) that thread t - 1 left at step s - 1 (a
    // shuffle in the warp, shared memory across warps, one barrier a step).
    const int rows = n - 1;
    const int active = (elems + CHUNK - 1) / CHUNK;  // threads that hold columns
    float ax = p0x, ay = p0y, bx = __ldg(pb + 2), by = __ldg(pb + 3);
    float cx = bx, cy = by;  // p[i + 2], read a step ahead
    if (n > 2) {
      cx = __ldg(pb + 4);
      cy = __ldg(pb + 5);
    }
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = INFINITY;
    for (int s = 0; s < rows + active - 1; ++s) {
      const int i = s - tid;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float from_left = __shfl_up_sync(0xffffffffu, x[k], 1);
        if (lane > 0) {
          x[k] = from_left;
        } else if (warp > 0) {
          x[k] = handoff[(s & 1) ^ 1][k][warp - 1];
        } else {
          x[k] = i <= left_reach[k] ? 0.f : INFINITY;
        }
      }
      if (tid < active && i >= 0 && i < rows) {
        const Seg sv = segment(ax, ay, bx, by);  // p's segment i
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const int j = j0 + c;
          // a cell whose R_V(i, j) and R_H(i, j) are empty at every
          // candidate leaves both exits empty, whatever its free intervals:
          // it is skipped (x and bot stay infinite)
          bool reachable = false;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            reachable = reachable || x[k] < INFINITY || bot[k][c] < INFINITY;
          }
          if (j < elems && reachable) {
            if constexpr (K == 1) {
              if (cells) ++reached;
            }
            // V(i, j+1) and H(i+1, j): the eps-invariant terms once
            const Cell wv = cell(sv, qx[c + 1], qy[c + 1]);
            const Seg sh = segment(qx[c], qy[c], qx[c + 1], qy[c + 1]);
            const Cell wh = cell(sh, bx, by);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              float a, h, tlo, thi;
              interval(sv, wv, e2[k], a, h);
              interval(sh, wh, e2[k], tlo, thi);
              // R_H(i+1, j) from R_V(i, j) = x and R_H(i, j) = bot; then R_V(i, j+1)
              const bool r = bot[k][c] < INFINITY;
              float t = x[k] < INFINITY ? tlo : (r ? fmaxf(tlo, bot[k][c]) : INFINITY);
              t = t <= thi ? t : INFINITY;
              if (r) {
                x[k] = a <= h ? a : INFINITY;
              } else {
                x[k] = (a <= h && x[k] <= h) ? fmaxf(a, x[k]) : INFINITY;
              }
              bot[k][c] = t;
              if (j == elems - 1 && i == rows - 1) {  // R_V(n-2, m-1), R_H(n-1, m-2)
                reach[k] = x[k] < INFINITY || t < INFINITY;
              }
            }
          }
        }
        ax = bx;
        ay = by;
        bx = cx;
        by = cy;
        if (i + 3 < n) {
          cx = __ldg(pb + 2 * i + 6);
          cy = __ldg(pb + 2 * i + 7);
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int k = 0; k < K; ++k) handoff[s & 1][k][warp] = x[k];
      }
      __syncthreads();
    }
  }
  if constexpr (K == 1) {
    if (cells && reached && live[0]) {
      atomicAdd(cells + (size_t)b * ok_stride + g, (unsigned long long)reached);
    }
  }
  if (j0 <= elems - 1 && elems - 1 < j0 + CHUNK) {
#pragma unroll
    for (int k = 0; k < K; ++k) decided[k] = (live[k] && reach[k]) ? 1 : 0;
  }
  __syncthreads();

  // publish the decisions; the pair's last block walks the tree
  if (threadIdx.x == 0) {
    int* bits = ok_bits + (size_t)b * ok_stride;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g * K + k < ncand) bits[g * K + k] = decided[k];
    }
    __threadfence();
    if (atomicAdd(done + b, 1u) == (unsigned)(groups - 1)) {
      __threadfence();
      const volatile int* vbits = bits;
      int v = 1;
      for (int s = 0; s < levels; ++s) {
        const float mid = midpoint(lo, hi);
        if (vbits[v - 1]) {
          hi = mid;
          v = 2 * v;
        } else {
          lo = mid;
          v = 2 * v + 1;
        }
      }
      lo_state[b] = lo;
      hi_state[b] = hi;
      if (last) out[b] = hi;
      done[b] = 0u;
    }
  }
}

struct Args {
  const float *p, *q;
  const int *n, *m;
  const float* hi;
  int B, P, Q, threads, levels, first, last;
  float *lo_state, *hi_state;
  int* ok_bits;
  int ok_stride;
  unsigned* done;
  float* out;
  unsigned long long* cells;
  cudaStream_t stream;
};

template <int CHUNK, int K>
cudaError_t launch(const Args& a) {
  const int groups = ((1 << a.levels) - 1 + K - 1) / K;
  frechet_kernel<CHUNK, K><<<a.B * groups, a.threads, 0, a.stream>>>(
      a.p, a.q, a.n, a.m, a.hi, a.P, a.Q, a.levels, a.first, a.last, a.lo_state, a.hi_state,
      a.ok_bits, a.ok_stride, a.done, a.out, a.cells);
  return cudaGetLastError();
}

template <int CHUNK, int K>
cudaError_t occupancy(int threads, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, frechet_kernel<CHUNK, K>, threads, 0);
}

// The instances that the launch plan can pick: chunk 1-8, and two candidates
// a block up to chunk 4 (k * chunk <= 8 keeps a thread's bottom edges in
// registers). F<chunk, k> is called with the arguments.
#define FRECHET_DISPATCH(F, chunk, k, ...)         \
  switch ((chunk) * 16 + (k)) {                    \
    case 1 * 16 + 1: return F<1, 1>(__VA_ARGS__); \
    case 2 * 16 + 1: return F<2, 1>(__VA_ARGS__); \
    case 3 * 16 + 1: return F<3, 1>(__VA_ARGS__); \
    case 4 * 16 + 1: return F<4, 1>(__VA_ARGS__); \
    case 5 * 16 + 1: return F<5, 1>(__VA_ARGS__); \
    case 6 * 16 + 1: return F<6, 1>(__VA_ARGS__); \
    case 7 * 16 + 1: return F<7, 1>(__VA_ARGS__); \
    case 8 * 16 + 1: return F<8, 1>(__VA_ARGS__); \
    case 1 * 16 + 2: return F<1, 2>(__VA_ARGS__); \
    case 2 * 16 + 2: return F<2, 2>(__VA_ARGS__); \
    case 3 * 16 + 2: return F<3, 2>(__VA_ARGS__); \
    case 4 * 16 + 2: return F<4, 2>(__VA_ARGS__); \
    default: return -1;                            \
  }

}  // namespace

extern "C" {

const char* frechet_decision_error_string(int err) {
  if (err == -1) return "unsupported (chunk, candidates a block) instance";
  if (err == -2) return "cells are counted at one candidate a block only";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One round of the bisection. p (B, P, 2), q (B, Q, 2) float32 on the
// device; n, m (B,) int32 true lengths (>= 2) on the device;
// hi (B,) the discrete Frechet (read when `first`); lo_state, hi_state (B,)
// the bracket between rounds; ok_bits (B, ok_stride) int32 with ok_stride >=
// 2^levels - 1; done (B,) zero before the first round (each round leaves it
// zero); out (B,) written when `last`; cells, if not null (k = 1 only),
// (B, ok_stride) uint64 to which each candidate's decision adds the cells of
// the true grid whose R_V(i, j) or R_H(i, j) it finds nonempty (none when
// its endpoints fail). threads * chunk must cover the longest m - 1.
// Returns a cudaError_t (0 on success), -1 for an instance that does not
// exist, -2 for cells at k > 1.
int frechet_decision(const float* p, const float* q, const int* n, const int* m, const float* hi,
                     int B, int P, int Q, int threads, int chunk, int k, int levels,
                     int first, int last, float* lo_state, float* hi_state, int* ok_bits,
                     int ok_stride, unsigned* done, float* out, unsigned long long* cells,
                     void* stream) {
  if (cells && k != 1) return -2;
  const Args a{p, q, n, m, hi, B, P, Q, threads, levels, first, last,
               lo_state, hi_state, ok_bits, ok_stride, done, out, cells,
               static_cast<cudaStream_t>(stream)};
  FRECHET_DISPATCH(launch, chunk, k, a)
}

// Blocks of `threads` threads of instance (chunk, k) that one SM holds at
// once.
int frechet_decision_blocks_per_sm(int threads, int chunk, int k, int* blocks) {
  FRECHET_DISPATCH(occupancy, chunk, k, threads, blocks)
}

}  // extern "C"
