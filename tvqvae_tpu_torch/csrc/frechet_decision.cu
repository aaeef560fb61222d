// Continuous Frechet distance: 30 bisection steps over the Alt-Godau
// free-space decision, one thread block per flight pair.
//
// Replaces the JAX package's jnp code (there is no pallas_call on this
// path): frechet_jax and _frechet_decision_jax in
// tvqvae_tpu/evaluation/flyability/distances.py:378-524. JAX runs the 30
// steps as a fori_loop, each decision as a lax.scan over p's segments whose
// in-row propagation is one lax.associative_scan of five-tuple maps
// (r, c, A, C, F), vmapped over a bucket of pairs.
//
// Design. The block holds the pair's true n and m points in shared memory
// and runs all 30 steps in one launch, starting from lo = max(endpoint
// distances) and the discrete Frechet (the DP kernel's output) as hi; the
// bisection state is the same in every thread. A decision walks the rows
// i = 0..n-2 (p's segments). Each thread owns CHUNK consecutive vertical
// edges of a row and keeps, in registers across rows, the reachable lo of
// the bottom edges below them. In a row it computes the free intervals of
// its vertical edges V(i, j+1), composes their maps into one five-tuple,
// and a block-wide exclusive scan (warp shuffles, then one warp over the
// warps' totals in shared memory) gives the map of everything before its
// chunk; applied to the row's left boundary value that yields R_V(i, j) at
// the chunk's start, and the thread walks its chunk, writing the top edges
// R_H(i+1, j). The composition keeps the A1 <= C2 cross term of JAX's
// combine (distances.py:440-470). Every step of it is a max, a min or a
// comparison, so the scan's order cannot change a decision: with the same
// free intervals this kernel decides as the JAX scan does.
//
// Free intervals are computed on the fly from the points (two per cell and
// step), never stored. Arithmetic: float32 with the round-to-nearest
// intrinsics, which nvcc never contracts into FMAs, in the plain PyTorch
// version's operation order.
//
// What bounds it on an H100: the chain of 30 x (n - 1) dependent rows, each
// with two barriers and a five-field shuffle scan; the operations (about 50
// a cell and step) bound it far lower.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSteps = 30;

struct Map {  // x -> r ? c : (F && x <= C ? max(A, x) : inf)
  float c, A, C;
  int flags;  // bit 0: r (reset), bit 1: F
};

__device__ __forceinline__ Map identity_map() { return {INFINITY, -INFINITY, INFINITY, 2}; }

// left then right (JAX's combine)
__device__ __forceinline__ Map compose(const Map& l, const Map& r) {
  const bool r2 = r.flags & 1, F1 = l.flags & 2, F2 = r.flags & 2;
  const float c12 = (F2 && l.c <= r.C) ? fmaxf(r.A, l.c) : INFINITY;
  Map o;
  o.c = r2 ? r.c : c12;
  o.A = fmaxf(l.A, r.A);
  o.C = fminf(l.C, r.C);
  o.flags = ((l.flags | r.flags) & 1) | ((F1 && F2 && l.A <= r.C) ? 2 : 0);
  return o;
}

__device__ __forceinline__ float apply_map(const Map& t, float x) {
  if (t.flags & 1) return t.c;
  return ((t.flags & 2) && x <= t.C) ? fmaxf(t.A, x) : INFINITY;
}

__device__ __forceinline__ Map shfl_up(const Map& t, int delta) {
  Map o;
  o.c = __shfl_up_sync(0xffffffffu, t.c, delta);
  o.A = __shfl_up_sync(0xffffffffu, t.A, delta);
  o.C = __shfl_up_sync(0xffffffffu, t.C, delta);
  o.flags = __shfl_up_sync(0xffffffffu, t.flags, delta);
  return o;
}

__device__ __forceinline__ float sq_dist(float ax, float ay, float bx, float by) {
  const float d0 = __fsub_rn(ax, bx), d1 = __fsub_rn(ay, by);
  return __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
}

// Free interval [lo, hi] of segment a->b within the e2 = eps^2 ball at c;
// empty as lo = 1 > hi = -1 (distances.py:378-400).
__device__ __forceinline__ void free_interval(float ax, float ay, float bx, float by, float cx,
                                              float cy, float e2, float& lo, float& hi) {
  const float d0 = __fsub_rn(bx, ax), d1 = __fsub_rn(by, ay);
  const float w0 = __fsub_rn(cx, ax), w1 = __fsub_rn(cy, ay);
  const float dd = __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
  const float ww = __fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1));
  const float ddc = fmaxf(dd, 1e-30f);
  float t0 = 0.f, disc;
  if (dd > 0.f) {
    t0 = __fdiv_rn(__fadd_rn(__fmul_rn(w0, d0), __fmul_rn(w1, d1)), ddc);
    disc = __fadd_rn(__fdiv_rn(__fsub_rn(e2, ww), ddc), __fmul_rn(t0, t0));
  } else {
    disc = ww <= e2 ? 1.f : -1.f;
  }
  if (disc >= 0.f) {
    const float r = __fsqrt_rn(disc);
    lo = fmaxf(__fsub_rn(t0, r), 0.f);
    hi = fminf(__fadd_rn(t0, r), 1.f);
  } else {
    lo = 1.f;
    hi = -1.f;
  }
}

template <int CHUNK>
__global__ void __launch_bounds__(1024) frechet_kernel(
    const float* __restrict__ p, const float* __restrict__ q, const int* __restrict__ n_arr,
    const int* __restrict__ m_arr, const float* __restrict__ hi_in, int P, int Q, int nmax,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ Map warp_total[2][32];
  __shared__ Map warp_prefix[2][32];
  __shared__ int first_not_full;
  __shared__ int accept;

  const int b = blockIdx.x;
  const int n = n_arr[b], m = m_arr[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* ps = smem;             // 2 * nmax
  float* qs = smem + 2 * nmax;  // 2 * m
  const float* pb = p + (size_t)b * P * 2;
  const float* qb = q + (size_t)b * Q * 2;
  for (int k = threadIdx.x; k < 2 * n; k += blockDim.x) ps[k] = pb[k];
  for (int k = threadIdx.x; k < 2 * m; k += blockDim.x) qs[k] = qb[k];
  __syncthreads();

  const int elems = m - 1;  // vertical edges V(i, j+1) / bottom edges j of a row
  const int j0 = threadIdx.x * CHUNK;
  float lo = fmaxf(__fsqrt_rn(sq_dist(ps[0], ps[1], qs[0], qs[1])),
                   __fsqrt_rn(sq_dist(ps[2 * n - 2], ps[2 * n - 1], qs[2 * m - 2], qs[2 * m - 1])));
  float hi = hi_in[b];

  for (int step = 0; step < kSteps; ++step) {
    const float eps = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const float e2 = __fmul_rn(eps, eps);
    const bool ok_ends =
        sq_dist(ps[0], ps[1], qs[0], qs[1]) <= e2 &&
        sq_dist(ps[2 * n - 2], ps[2 * n - 1], qs[2 * m - 2], qs[2 * m - 1]) <= e2;
    bool ok = false;
    if (ok_ends) {  // uniform across the block
      // bottom boundary R_H(0, j): reachable while every earlier edge is full
      float bot[CHUNK], blo[CHUNK], bhi[CHUNK];
      if (threadIdx.x == 0) first_not_full = elems;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int j = j0 + k;
        if (j < elems) {
          free_interval(qs[2 * j], qs[2 * j + 1], qs[2 * j + 2], qs[2 * j + 3], ps[0], ps[1], e2,
                        blo[k], bhi[k]);
          if (!(blo[k] <= 0.f && bhi[k] >= 1.f)) atomicMin(&first_not_full, j);
        }
      }
      __syncthreads();
      const int first = first_not_full;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const int j = j0 + k;
        bot[k] = INFINITY;
        if (j < elems) {
          const float x = (j <= first && blo[k] <= 0.f) ? 0.f : INFINITY;
          bot[k] = x <= bhi[k] ? x : INFINITY;
        }
      }
      bool left_prefix = true;  // every left-boundary edge below row i is full
      bool reach_v = false, accept_h = false;
      for (int i = 0; i + 1 < n; ++i) {
        const float pax = ps[2 * i], pay = ps[2 * i + 1];
        const float pbx = ps[2 * i + 2], pby = ps[2 * i + 3];
        // left boundary R_V(i, 0), computed by every thread alike
        float vlo, vhi;
        free_interval(pax, pay, pbx, pby, qs[0], qs[1], e2, vlo, vhi);
        float rv_left = (left_prefix && vlo <= 0.f) ? 0.f : INFINITY;
        rv_left = rv_left <= vhi ? rv_left : INFINITY;
        left_prefix = left_prefix && vlo <= 0.f && vhi >= 1.f;

        // this thread's maps of V(i, j+1), composed
        float a[CHUNK], h[CHUNK];
        Map agg = identity_map();
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          const int j = j0 + k;
          if (j < elems) {
            free_interval(pax, pay, pbx, pby, qs[2 * j + 2], qs[2 * j + 3], e2, a[k], h[k]);
            const bool r = bot[k] < INFINITY, valid = a[k] <= h[k];
            const Map e = {(r && valid) ? a[k] : INFINITY, a[k], h[k],
                           (r ? 1 : 0) | (valid ? 2 : 0)};
            agg = compose(agg, e);
          }
        }
        // block exclusive scan of the threads' maps
        Map inc = agg;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const Map o = shfl_up(inc, off);
          if (lane >= off) inc = compose(o, inc);
        }
        Map before = shfl_up(inc, 1);
        if (lane == 0) before = identity_map();
        const int parity = i & 1;
        if (lane == 31) warp_total[parity][warp] = inc;
        __syncthreads();
        if (warp == 0) {
          Map t = lane < nwarps ? warp_total[parity][lane] : identity_map();
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const Map o = shfl_up(t, off);
            if (lane >= off) t = compose(o, t);
          }
          Map ex = shfl_up(t, 1);
          if (lane == 0) ex = identity_map();
          warp_prefix[parity][lane] = ex;
        }
        __syncthreads();
        float x = apply_map(compose(warp_prefix[parity][warp], before), rv_left);  // R_V(i, j0)

        // walk the chunk: top edges R_H(i+1, j), then R_V(i, j+1)
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          const int j = j0 + k;
          if (j < elems) {
            float tlo, thi;
            free_interval(qs[2 * j], qs[2 * j + 1], qs[2 * j + 2], qs[2 * j + 3], pbx, pby, e2,
                          tlo, thi);
            const bool r = bot[k] < INFINITY;
            float t = x < INFINITY ? tlo : (r ? fmaxf(tlo, bot[k]) : INFINITY);
            t = t <= thi ? t : INFINITY;
            if (r) {
              x = a[k] <= h[k] ? a[k] : INFINITY;
            } else {
              x = (a[k] <= h[k] && x <= h[k]) ? fmaxf(a[k], x) : INFINITY;
            }
            bot[k] = t;
            if (j == elems - 1) {  // the row's last edge: R_V(i, m-1), R_H(i+1, m-2)
              reach_v = x < INFINITY;
              accept_h = t < INFINITY;
            }
          }
        }
      }
      if (threadIdx.x == 0) accept = 0;
      __syncthreads();
      if ((j0 <= elems - 1 && elems - 1 < j0 + CHUNK) && (reach_v || accept_h)) accept = 1;
      __syncthreads();
      ok = accept != 0;
      __syncthreads();
    }
    if (ok) {
      hi = eps;
    } else {
      lo = eps;
    }
  }
  if (threadIdx.x == 0) out[b] = hi;
}

template <int CHUNK>
cudaError_t launch(const float* p, const float* q, const int* n, const int* m, const float* hi,
                   int B, int P, int Q, int nmax, int mmax, int threads, float* out,
                   cudaStream_t stream) {
  const int smem = 8 * (nmax + mmax);
  cudaError_t err = cudaFuncSetAttribute(frechet_kernel<CHUNK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  frechet_kernel<CHUNK><<<B, threads, smem, stream>>>(p, q, n, m, hi, P, Q, nmax, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* frechet_decision_error_string(int err) {
  if (err == -1) return "unsupported chunk (1, 2, 4 or 8 elements a thread)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// p (B, P, 2), q (B, Q, 2) float32 on the device; n, m (B,) int32 true
// lengths (>= 2) on the device, at most nmax, mmax; hi (B,) the discrete
// Frechet; out (B,). threads * chunk must cover mmax - 1. Returns a
// cudaError_t (0 on success).
int frechet_decision(const float* p, const float* q, const int* n, const int* m,
                     const float* hi, int B, int P, int Q, int nmax, int mmax, int threads,
                     int chunk, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 1: return launch<1>(p, q, n, m, hi, B, P, Q, nmax, mmax, threads, out, s);
    case 2: return launch<2>(p, q, n, m, hi, B, P, Q, nmax, mmax, threads, out, s);
    case 4: return launch<4>(p, q, n, m, hi, B, P, Q, nmax, mmax, threads, out, s);
    case 8: return launch<8>(p, q, n, m, hi, B, P, Q, nmax, mmax, threads, out, s);
    default: return -1;
  }
}

}  // extern "C"
