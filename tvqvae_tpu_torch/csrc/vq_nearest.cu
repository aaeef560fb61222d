// Nearest-code assignment and codebook statistics for vector quantization.
//
// Replaces the TPU kernel tvqvae_tpu/ops/vq_pallas.py::_kernel (reached
// through nearest_codes_stats_pallas). For flat (M, D) and embed (K, D), all
// float32 and row-major, it computes
//
//   dist[m, k]   = 2 * <x_m, e_k> - |x_m|^2 - |e_k|^2    (exact fp32)
//   idx[m]       = argmax_k dist[m, k]   (first index on ties, NaN as max)
//   counts[k]    = #{m : idx[m] == k}
//   embed_sum[k] = sum over m with idx[m] == k of x_m   (in row order)
//
// What bounds it on an H100. At the published shapes (D=128, K=32, M = 864
// for LF and 3456 for HF) one call reads ~1.8 MB and does ~28 MFLOP, which
// the card moves in under a microsecond: the call is bound by its launches,
// not by bytes or operations. At K=2048 the 1.8 GFLOP of fp32 dot products
// dominate (about 27 us at the 67 TFLOP/s fp32 peak outside tensor cores).
//
// What the design does about it:
//   - Two launches and nothing else: no (M, K) distance or one-hot matrix
//     ever reaches device memory, as in the TPU kernel.
//   - Kernel A (assign): a block takes 16 rows and walks the codebook in
//     chunks of 64 codes staged in shared memory (rows padded to D+1 floats,
//     so the inner loop has no bank conflicts). 16 threads share a row; each
//     keeps 4 dot products in flight (plain FFMA: the reference computes at
//     Precision.HIGHEST, and TF32 tensor cores would move argmins), then the
//     16 partial winners meet in a warp-shuffle reduction that keeps the
//     lowest index on ties.
//   - Kernel B (statistics): the TPU kernel sums counts and embed_sum across
//     sequential grid steps; GPU blocks run in no order, so instead one block
//     owns one code, scans idx in chunks of 128 rows, compacts the matching
//     rows in order (ballot + popc) and sums them column-parallel. No atomics:
//     the result is the same on every run, so an argmin flip cannot hide
//     behind run-to-run noise.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kAssignThreads = 256;
constexpr int kRowsPerBlock = 16;
constexpr int kThreadsPerRow = kAssignThreads / kRowsPerBlock;           // 16
constexpr int kCodesPerThread = 4;
constexpr int kCodesPerChunk = kThreadsPerRow * kCodesPerThread;          // 64
constexpr int kStatsThreads = 128;
constexpr int kMaxDim = 4 * kStatsThreads;                                // 512

// Is (a, ia) preferred over (b, ib)? argmax order: NaN above every number,
// the lower index on ties; an index < 0 marks "nothing yet".
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kAssignThreads)
assign_kernel(const float* __restrict__ flat, const float* __restrict__ embed,
              int M, int K, int D, int* __restrict__ idx) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* xs = smem;                            // [kRowsPerBlock][ld]
  float* es = xs + kRowsPerBlock * ld;         // [kCodesPerChunk][ld]
  float* e2s = es + kCodesPerChunk * ld;       // [kCodesPerChunk]
  float* x2s = e2s + kCodesPerChunk;           // [kRowsPerBlock]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int r = tid / kThreadsPerRow;
  const int j = tid % kThreadsPerRow;

  for (int i = tid; i < kRowsPerBlock * D; i += kAssignThreads) {
    const int rr = i / D, d = i - rr * D, m = row0 + rr;
    xs[rr * ld + d] = m < M ? flat[(size_t)m * D + d] : 0.f;
  }
  __syncthreads();
  if (tid < kRowsPerBlock) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(xs[tid * ld + d], xs[tid * ld + d], s);
    x2s[tid] = s;
  }

  float best = 0.f;
  int best_k = -1;
  const float* xr = xs + r * ld;
  for (int k0 = 0; k0 < K; k0 += kCodesPerChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kCodesPerChunk * D; i += kAssignThreads) {
      const int c = i / D, d = i - c * D, k = k0 + c;
      es[c * ld + d] = k < K ? embed[(size_t)k * D + d] : 0.f;
    }
    __syncthreads();
    if (tid < kCodesPerChunk) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(es[tid * ld + d], es[tid * ld + d], s);
      e2s[tid] = s;
    }
    __syncthreads();

    float acc[kCodesPerThread];
#pragma unroll
    for (int u = 0; u < kCodesPerThread; ++u) acc[u] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float xv = xr[d];
#pragma unroll
      for (int u = 0; u < kCodesPerThread; ++u)
        acc[u] = fmaf(xv, es[(j + u * kThreadsPerRow) * ld + d], acc[u]);
    }
    const float x2 = x2s[r];
#pragma unroll
    for (int u = 0; u < kCodesPerThread; ++u) {  // codes in increasing order
      const int c = j + u * kThreadsPerRow, k = k0 + c;
      if (k < K) {
        const float dist = (2.f * acc[u] - x2) - e2s[c];
        if (better(dist, k, best, best_k)) { best = dist; best_k = k; }
      }
    }
  }

  // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
  for (int off = kThreadsPerRow / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
    if (better(ov, ok, best, best_k)) { best = ov; best_k = ok; }
  }
  if (j == 0 && row0 + r < M) idx[row0 + r] = best_k;
}

__global__ void __launch_bounds__(kStatsThreads)
stats_kernel(const float* __restrict__ flat, const int* __restrict__ idx,
             int M, int D, float* __restrict__ counts,
             float* __restrict__ embed_sum) {
  __shared__ int rows[kStatsThreads];
  __shared__ int warp_hits[kStatsThreads / 32];
  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float acc[kMaxDim / kStatsThreads];
#pragma unroll
  for (int u = 0; u < kMaxDim / kStatsThreads; ++u) acc[u] = 0.f;
  int count = 0;

  for (int m0 = 0; m0 < M; m0 += kStatsThreads) {
    const int m = m0 + tid;
    const bool hit = m < M && idx[m] == k;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kStatsThreads / 32; ++w) {
      offset += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) rows[offset + __popc(mask & ((1u << lane) - 1u))] = m;
    __syncthreads();
    for (int i = 0; i < total; ++i) {  // matching rows in increasing order
      const float* xr = flat + (size_t)rows[i] * D;
#pragma unroll
      for (int u = 0; u < kMaxDim / kStatsThreads; ++u) {
        const int d = tid + u * kStatsThreads;
        if (d < D) acc[u] += xr[d];
      }
    }
    count += total;
    __syncthreads();  // rows and warp_hits are rewritten next chunk
  }

  if (tid == 0) counts[k] = (float)count;
#pragma unroll
  for (int u = 0; u < kMaxDim / kStatsThreads; ++u) {
    const int d = tid + u * kStatsThreads;
    if (d < D) embed_sum[(size_t)k * D + d] = acc[u];
  }
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() as an int
// (0 on success). The caller allocates the outputs and checks 1 <= D <= 512,
// M >= 1 and K >= 1.
extern "C" int vq_nearest_stats(const float* flat, const float* embed, int M,
                                int K, int D, int* idx, float* counts,
                                float* embed_sum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * ((size_t)(kRowsPerBlock + kCodesPerChunk) * (D + 1) +
                       kCodesPerChunk + kRowsPerBlock);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  assign_kernel<<<blocks, kAssignThreads, smem, s>>>(flat, embed, M, K, D, idx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_kernel<<<K, kStatsThreads, 0, s>>>(flat, idx, M, D, counts, embed_sum);
  return (int)cudaGetLastError();
}

extern "C" const char* vq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
