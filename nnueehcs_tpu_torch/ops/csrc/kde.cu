// Exact Gaussian-KDE log density for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/kde.py::_kde_kernel (the Pallas TPU kernel).
// Same function: for each query row x (centred at the reference mean, as
// the references are), out = m + log(s), the log-sum-exp over every
// reference y of -gamma * max(|x|^2 + |y|^2 - 2 x.y, 0), with the cross
// term at full fp32. The log normalising constant is added by the caller.
// Only the (B,) result is written to device memory; the (B, N) exponent
// matrix never exists.
//
// What bounds it on an H100: operations. A pair costs d FFMAs for the
// cross term, an add, the clamp, the group max, the subtraction and the sum
// (about 2d + 6 fp32 operations), and one MUFU ex2. At the bench's d = 5
// that is 16 FLOP and one ex2 per pair against 4(d + 1) bytes per query
// and 4d per reference, so the larger of FLOP / 67 TFLOP/s and
// pairs / (16 ex2 per SM per clock x SMs x clock) bounds it; bytes do not.
//
// What the design does about it:
// - the exponent is taken in base 2: gamma * log2(e) is folded into the
//   staged references (2 g2 y and -g2 |y|^2, with g2 = gamma log2 e), so a
//   pair is an add, d FFMAs and a min, and each exp is one ex2.approx;
// - each thread keeps 4 query rows in registers with their running max m
//   and sum s; the block streams the corpus through shared memory in tiles
//   of 256 references, each staged once as float4-aligned records
//   (2 g2 y, -g2 |y|^2), so one broadcast 16-byte load feeds 4 rows;
// - references go in groups of 8: the group max first, the running sum
//   rescaled once if the max rose (the TPU kernel does this per tile), then
//   the 8 ex2s; padded slots of the last group carry -inf and add 0;
// - m starts at -inf, and the first group always holds a real reference,
//   so m is finite from then on and a far-OOD row, whose every exp
//   underflows, still gets a finite m + log(s) with s >= 1.
// Shared memory: 256 x 8 floats (8 KB) at d = 5, 12 KB at d = 8. Registers:
// the 4 x d rows, the 4 x 8 group exponents and one record, about 100 at
// d = 8 (ptxas -v reports the real count), so four 128-thread blocks fit
// an SM.
//
// Any d: d <= 8 takes the register path above, compiled for each d; a
// wider d takes the general kernel, one row per thread, which accumulates
// the cross terms of a 32-reference tile in registers over 32-feature
// chunks of x and the references staged in shared memory (21 KB). Ragged
// B and N need no padding copies: rows past B are never written and
// references past N are masked to -inf. No tensor cores: the JAX kernel
// computes the cross term at full fp32, and at d <= 8 the product is too
// thin for wgmma.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr double kLog2e = 1.4426950408889634;
constexpr float kLn2 = 0.69314718055994531f;

// register path
constexpr int kRows = 4;      // query rows per thread
constexpr int kGroup = 8;     // references per max/rescale group
constexpr int kTile = 256;    // references per staged tile
// general path
constexpr int kGenTile = 32;  // references per tile (and per group)
constexpr int kGenChunk = 32; // features per staged chunk

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Fold a group of base-2 exponents (each <= 0, -inf for padding, at least
// one finite while m is -inf) into the running max m and sum s.
template <int G>
__device__ __forceinline__ void lse_update(float& m, float& s,
                                           const float (&e)[G]) {
  float gm = e[0];
#pragma unroll
  for (int j = 1; j < G; ++j) gm = fmaxf(gm, e[j]);
  if (gm > m) {  // ex2(-inf) = 0 clears the m = -inf start
    s *= ex2(m - gm);
    m = gm;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) acc += ex2(e[j] - m);
  s += acc;
}

// d = D <= 8: kRows rows per thread, row r of thread t at
// blockIdx.x * kThreads * kRows + r * kThreads + t.
template <int D>
__global__ void __launch_bounds__(kThreads, 4)
    kde_small_kernel(const float* __restrict__ x, long long B,
                     const float* __restrict__ y, int N, float g2,
                     float* __restrict__ out) {
  constexpr int P = (D + 1 + 3) / 4 * 4;  // floats per staged record
  __shared__ __align__(16) float sy[kTile * P];

  const long long row0 =
      static_cast<long long>(blockIdx.x) * kThreads * kRows + threadIdx.x;
  float xr[kRows][D], a[kRows], m[kRows], s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r * kThreads;
    float x2 = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xr[r][k] = row < B ? __ldg(x + row * D + k) : 0.f;
      x2 = fmaf(xr[r][k], xr[r][k], x2);
    }
    a[r] = -g2 * x2;
    m[r] = -INFINITY;
    s[r] = 0.f;
  }

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int nt = min(kTile, N - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      float rec[P];
#pragma unroll
      for (int k = 0; k < P; ++k) rec[k] = 0.f;
      if (j < nt) {
        const float* yj = y + static_cast<long long>(t0 + j) * D;
        float y2 = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float v = __ldg(yj + k);
          y2 = fmaf(v, v, y2);
          rec[k] = 2.f * g2 * v;
        }
        rec[D] = -g2 * y2;
      } else {
        rec[D] = -INFINITY;
      }
      float4* dst = reinterpret_cast<float4*>(sy + j * P);
#pragma unroll
      for (int q = 0; q < P / 4; ++q)
        dst[q] = make_float4(rec[4 * q], rec[4 * q + 1], rec[4 * q + 2],
                             rec[4 * q + 3]);
    }
    __syncthreads();

    const int groups = (nt + kGroup - 1) / kGroup;
    for (int g = 0; g < groups; ++g) {
      float e[kRows][kGroup];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        float rec[P];
        const float4* src =
            reinterpret_cast<const float4*>(sy + (g * kGroup + jj) * P);
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 v = src[q];
          rec[4 * q] = v.x;
          rec[4 * q + 1] = v.y;
          rec[4 * q + 2] = v.z;
          rec[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float acc = a[r] + rec[D];
#pragma unroll
          for (int k = 0; k < D; ++k) acc = fmaf(xr[r][k], rec[k], acc);
          e[r][jj] = fminf(acc, 0.f);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) lse_update(m[r], s[r], e[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r * kThreads;
    if (row < B) out[row] = fmaf(m[r], kLn2, logf(s[r]));
  }
}

// Any d: one row per thread; per tile of kGenTile references the cross
// terms accumulate in registers over kGenChunk-feature chunks staged in
// shared memory (x dim-major, padded against bank conflicts).
__global__ void __launch_bounds__(kThreads)
    kde_general_kernel(const float* __restrict__ x, long long B,
                       const float* __restrict__ y, int N, int d, float g2,
                       float* __restrict__ out) {
  __shared__ float sx[kGenChunk][kThreads + 1];
  __shared__ float sy[kGenTile][kGenChunk + 1];
  __shared__ float sb[kGenTile];

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                        B - row0));
  float x2 = 0.f, m = -INFINITY, s = 0.f;

  for (int t0 = 0; t0 < N; t0 += kGenTile) {
    const int nt = min(kGenTile, N - t0);
    float acc[kGenTile];
#pragma unroll
    for (int j = 0; j < kGenTile; ++j) acc[j] = 0.f;
    float y2 = 0.f;  // thread j < kGenTile: |y_j|^2 so far
    for (int k0 = 0; k0 < d; k0 += kGenChunk) {
      const int kc = min(kGenChunk, d - k0);
      __syncthreads();  // the previous chunk (and tile's sb) is consumed
      for (int i = tid; i < kThreads * kc; i += kThreads) {
        const int r = i / kc, k = i - r * kc;
        sx[k][r] = r < rows ? __ldg(x + (row0 + r) * d + k0 + k) : 0.f;
      }
      for (int i = tid; i < kGenTile * kc; i += kThreads) {
        const int j = i / kc, k = i - j * kc;
        sy[j][k] = j < nt
            ? __ldg(y + static_cast<long long>(t0 + j) * d + k0 + k) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const float xv = sx[k][tid];
        if (t0 == 0) x2 = fmaf(xv, xv, x2);
#pragma unroll
        for (int j = 0; j < kGenTile; ++j) acc[j] = fmaf(xv, sy[j][k], acc[j]);
      }
      if (tid < kGenTile)
        for (int k = 0; k < kc; ++k) y2 = fmaf(sy[tid][k], sy[tid][k], y2);
    }
    if (tid < kGenTile) sb[tid] = tid < nt ? -g2 * y2 : -INFINITY;
    __syncthreads();
    const float a = -g2 * x2;
    float e[kGenTile];
#pragma unroll
    for (int j = 0; j < kGenTile; ++j)
      e[j] = fminf(fmaf(2.f * g2, acc[j], a + sb[j]), 0.f);
    lse_update(m, s, e);
  }
  const long long row = row0 + tid;
  if (row < B) out[row] = fmaf(m, kLn2, logf(s));
}

template <int D>
cudaError_t launch_small(const float* x, long long B, const float* y, int N,
                         float g2, float* out, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kRows;
  const long long blocks = (B + per_block - 1) / per_block;
  kde_small_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, B, y, N, g2, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks B >= 1, N >= 1, d >= 1, fp32 contiguous device buffers x (B, d)
// and y (N, d), both centred at the reference mean, and allocates out (B,).
// out[i] = log sum_j exp(-gamma |x_i - y_j|^2), without the normalising
// constant.
int nnueehcs_kde_logpdf_f32(const float* x, long long B, const float* y,
                            int N, int d, double gamma, float* out,
                            void* stream) {
  const float g2 = static_cast<float>(gamma * kLog2e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return static_cast<int>(launch_small<1>(x, B, y, N, g2, out, st));
    case 2: return static_cast<int>(launch_small<2>(x, B, y, N, g2, out, st));
    case 3: return static_cast<int>(launch_small<3>(x, B, y, N, g2, out, st));
    case 4: return static_cast<int>(launch_small<4>(x, B, y, N, g2, out, st));
    case 5: return static_cast<int>(launch_small<5>(x, B, y, N, g2, out, st));
    case 6: return static_cast<int>(launch_small<6>(x, B, y, N, g2, out, st));
    case 7: return static_cast<int>(launch_small<7>(x, B, y, N, g2, out, st));
    case 8: return static_cast<int>(launch_small<8>(x, B, y, N, g2, out, st));
    default: break;
  }
  const long long blocks = (B + kThreads - 1) / kThreads;
  kde_general_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, B, y, N, d, g2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
