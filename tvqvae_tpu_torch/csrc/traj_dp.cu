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
// Design. One thread block per (flight pair, variant); a variant is a kind
// (the recurrence), a metric (the cost) and an epsilon. The block loads the
// pair's true n and m points into shared memory as per-point features
// (planar: lat, lon; spherical: lat and lon in radians and cos(lat)) with
// the per-point gap costs of ERP, and sweeps the anti-diagonals of the
// augmented (n + 1) x (m + 1) grid: the cells of one diagonal depend only
// on the two before it, so each diagonal is one parallel step and one
// barrier. Three diagonals of min(n, m) floats live in shared memory,
// indexed by row modulo their length; the costs are computed on the fly
// and never stored, so no (P, Q) buffer exists. Each cell is the textbook
// recurrence, which equals the JAX package's row form cell by cell (a row
// scan composes the same min/max/+ terms in another order, so DTW and ERP
// differ from it by rounding only; EDR and LCSS count in exact integers;
// the discrete Frechet only selects).
//
// Why a wavefront and not a block scan of the rows: a row scan needs two
// or three barriers per row plus the scan's shuffles and holds the
// composed pairs of JAX's combine; the wavefront needs one barrier per
// diagonal and no combine, and runs only the true n x m cells (the bucket
// padding never reaches the true corner).
//
// Precision: float32 as in JAX. The costs use the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fsqrt_rn), which nvcc never
// contracts into FMAs, and IEEE sinf / cosf / asinf (no fast math), in the
// plain PyTorch version's operation order, so both compute the same costs.
//
// What bounds it on an H100: the chain of n + m - 1 dependent diagonals,
// one barrier each (a few hundred ns with the cost's latency); its
// operations (about 10 a planar cell, 25 a spherical one) and bytes (the
// points, read once) bound it far lower.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxVariants = 16;
enum Kind { kDTW = 0, kERP = 1, kEDR = 2, kLCSS = 3, kDiscreteFrechet = 4 };

struct Variants {
  int kind[kMaxVariants];
  int spherical[kMaxVariants];
  float eps[kMaxVariants];
};

constexpr float kDegToRad = 0.017453292519943295f;  // float32(pi / 180), as jnp.radians
constexpr float kTwoR = 12756274.0f;                 // 2 * 6378137 m, exact in float32

// Per-point features: planar (lat, lon, -); spherical (lat, lon in radians, cos lat).
__device__ __forceinline__ void point_features(float lat, float lon, bool sph, float* f) {
  if (sph) {
    const float la = __fmul_rn(lat, kDegToRad);
    f[0] = la;
    f[1] = __fmul_rn(lon, kDegToRad);
    f[2] = cosf(la);
  } else {
    f[0] = lat;
    f[1] = lon;
    f[2] = 0.f;
  }
}

// d(a, b): planar sqrt(d0^2 + d1^2 + 1e-30); spherical
// 2R asin(sqrt(clip(sin^2(dlat / 2) + (cos lat_a cos lat_b) sin^2(dlon / 2), 0, 1))).
__device__ __forceinline__ float point_dist(const float* a, const float* b, bool sph) {
  if (!sph) {
    const float d0 = __fsub_rn(a[0], b[0]), d1 = __fsub_rn(a[1], b[1]);
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), 1e-30f));
  }
  const float s0 = sinf(__fmul_rn(__fsub_rn(b[0], a[0]), 0.5f));
  const float s1 = sinf(__fmul_rn(__fsub_rn(b[1], a[1]), 0.5f));
  float s = __fadd_rn(__fmul_rn(s0, s0), __fmul_rn(__fmul_rn(a[2], b[2]), __fmul_rn(s1, s1)));
  s = fminf(fmaxf(s, 0.f), 1.f);
  return __fmul_rn(kTwoR, asinf(__fsqrt_rn(s)));
}

// Deterministic block sum of x[0..count) (strided per thread, then a tree).
__device__ float block_sum(const float* x, int count, float* scratch) {
  float s = 0.f;
  for (int k = threadIdx.x; k < count; k += blockDim.x) s = __fadd_rn(s, x[k]);
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = s;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total = __fadd_rn(total, scratch[w]);
  return total;
}

__global__ void __launch_bounds__(1024) traj_dp_kernel(
    const float* __restrict__ p, const float* __restrict__ q, const int* __restrict__ n_arr,
    const int* __restrict__ m_arr, int P, int Q, int nmax, int mmax, float g0, float g1,
    Variants var, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, v = blockIdx.y, V = gridDim.y;
  const int n = n_arr[b], m = m_arr[b];
  const int kind = var.kind[v];
  const bool sph = var.spherical[v] != 0;
  const float eps = var.eps[v];
  const int W = min(nmax, mmax);  // >= every diagonal's length, min(n, m)

  float* pf = smem;              // 3 * nmax
  float* qf = pf + 3 * nmax;     // 3 * mmax
  float* gp = qf + 3 * mmax;     // nmax: ERP gap costs d(p_i, g)
  float* gq = gp + nmax;         // mmax: d(q_j, g)
  float* diag_buf = gq + mmax;   // 3 * W
  float* scratch = diag_buf + 3 * W;  // 32

  float gf[3];
  point_features(g0, g1, sph, gf);
  const float* pb = p + (size_t)b * P * 2;
  const float* qb = q + (size_t)b * Q * 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    point_features(pb[2 * i], pb[2 * i + 1], sph, pf + 3 * i);
    gp[i] = kind == kERP ? point_dist(pf + 3 * i, gf, sph) : 0.f;
  }
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    point_features(qb[2 * j], qb[2 * j + 1], sph, qf + 3 * j);
    gq[j] = kind == kERP ? point_dist(qf + 3 * j, gf, sph) : 0.f;
  }
  __syncthreads();

  // borders of the augmented grid D[0..n][0..m]: D[0][0], D[0][j > 0], D[i > 0][0]
  float corner = 0.f, top = 0.f, left = 0.f;
  if (kind == kDTW || kind == kDiscreteFrechet) {
    top = left = INFINITY;
  } else if (kind == kERP) {  // traj-dist: the TOTAL gap sums
    top = block_sum(gq, m, scratch);
    left = block_sum(gp, n, scratch);
  }

  float* d2 = diag_buf;          // diagonal d - 2
  float* d1 = diag_buf + W;      // diagonal d - 1
  float* d0 = diag_buf + 2 * W;  // diagonal d
  for (int d = 2; d <= n + m; ++d) {
    const int ilo = max(1, d - m), ihi = min(n, d - 1);
    for (int i = ilo + threadIdx.x; i <= ihi; i += blockDim.x) {
      const int j = d - i;
      const float up = i > 1 ? d1[(i - 1) % W] : top;                    // D[i-1][j]
      const float lf = j > 1 ? d1[i % W] : left;                         // D[i][j-1]
      const float dg = (i > 1 && j > 1) ? d2[(i - 1) % W]                // D[i-1][j-1]
                       : (i == 1 && j == 1) ? corner : (i == 1 ? top : left);
      const float c = point_dist(pf + 3 * (i - 1), qf + 3 * (j - 1), sph);
      float x;
      switch (kind) {
        case kDTW:
          x = __fadd_rn(c, fminf(fminf(up, dg), lf));
          break;
        case kERP:
          x = fminf(fminf(__fadd_rn(dg, c), __fadd_rn(up, gp[i - 1])), __fadd_rn(lf, gq[j - 1]));
          break;
        case kEDR:
          x = fminf(fminf(dg + (c >= eps ? 1.f : 0.f), up + 1.f), lf + 1.f);
          break;
        case kLCSS:
          x = fmaxf(fmaxf(dg + (c < eps ? 1.f : 0.f), up), lf);
          break;
        default:  // kDiscreteFrechet
          x = fmaxf(c, fminf(fminf(up, dg), lf));
      }
      d0[i % W] = x;
    }
    __syncthreads();
    float* t = d2;
    d2 = d1;
    d1 = d0;
    d0 = t;
  }

  if (threadIdx.x == 0) {
    float x = d1[n % W];  // D[n][m], on the last diagonal
    if (kind == kEDR) x = __fdiv_rn(x, (float)max(n, m));
    if (kind == kLCSS) x = __fsub_rn(1.f, __fdiv_rn(x, (float)min(n, m)));
    out[(size_t)b * V + v] = x;
  }
}

}  // namespace

extern "C" {

const char* traj_dp_error_string(int err) {
  if (err == -1) return "more than 16 variants";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// p (B, P, 2), q (B, Q, 2) float32 on the device; n, m (B,) int32 true
// lengths on the device, at most nmax, mmax; kinds / metrics / eps: V host
// values; out (B, V) float32. Returns a cudaError_t (0 on success).
int traj_dp(const float* p, const float* q, const int* n, const int* m, int B, int P, int Q,
            int nmax, int mmax, float g0, float g1, int V, const int* kinds,
            const int* metrics, const float* eps, int threads, int smem_bytes, float* out,
            void* stream) {
  if (V < 1 || V > kMaxVariants) return -1;
  Variants var = {};
  for (int v = 0; v < V; ++v) {
    var.kind[v] = kinds[v];
    var.spherical[v] = metrics[v];
    var.eps[v] = eps[v];
  }
  cudaError_t err = cudaFuncSetAttribute(traj_dp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  traj_dp_kernel<<<dim3(B, V), threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p, q, n, m, P, Q, nmax, mmax, g0, g1, var, out);
  return cudaGetLastError();
}

}  // extern "C"
