// Exact Gaussian-KDE log density for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/kde.py::_kde_kernel (the Pallas TPU kernel).
// Same function: for each query row x (centred at the reference mean, as
// the references are), out = m + log(s), the log-sum-exp over every
// reference y of -gamma * max(|x|^2 + |y|^2 - 2 x.y, 0), with the cross
// term at fp32 accuracy. The log normalising constant is added by the
// caller. Only the (B,) result is written to device memory; the (B, N)
// exponent matrix never exists.
//
// What bounds it on an H100: operations, by pipe (ops/kde.py
// kde_bound_terms counts them from the function). A pair needs its
// exponent, one exp, and the log-sum-exp's clamp, max, subtraction and sum.
// The exponent of a pair is one dot of depth d + 2 with the constants
// folded in (below); an exp is one MUFU ex2 (16 a clock per SM) or a
// polynomial on the FMA pipe; the clamp and max run on the ALU pipe (64 a
// clock), the subtraction and sum on the FMA pipe (128 a clock), and an SM
// issues 128 thread instructions a clock. Bytes do not count: 4(d + 1) per
// query and 4d per reference.
//
// What the design does about it (d <= 8, the register path):
// - the exponent is taken in base 2 and runs on the tensor cores: with
//   g2 = gamma log2 e, x' = [x, 1, -g2 |x|^2] and y' = [2 g2 y, -g2 |y|^2, 1]
//   (zeros up to a multiple of 8) give x'.y' = -g2 (|x|^2 + |y|^2 - 2 x.y),
//   one mma.sync m16n8k8 TF32 product per 8 features for 16 queries by 8
//   references. Each operand is split into a TF32 head and a TF32 tail, and
//   three products (tail x head, head x tail, head x head, the small terms
//   first) keep the dot at fp32 accuracy (the 3xTF32 split);
// - that leaves the CUDA cores the log-sum-exp alone: per pair the clamp at
//   0, the group max, the subtraction, one ex2.approx and the sum;
// - a warp owns 32 queries (two 16-row A operands, head and tail, in
//   registers for the whole corpus); the block streams the corpus through
//   shared memory in tiles of 256 references, each staged once as the
//   B operands' fragments (one 16-byte load a lane gives a k step's head
//   and tail of 8 references); a lane's C values of a group of 32
//   references give each of its 4 rows 8 exponents (the fastest of the
//   shapes tried on the card: 32 to 64 queries a warp, groups of 16 to 64);
// - each lane keeps a running max m and sum s for each of its rows over
//   its own columns: the group max first, the sum rescaled if the max rose
//   (a branch the warp takes as a whole, rarely once the max has settled),
//   then the exps; the four lanes of a row merge their (m, s) at the end.
//   m starts at -inf; padded references past N carry the exponent
//   -1e30 (finite, so the split and the products stay finite), whose ex2 is
//   0 against any real exponent; so a row's merged m is its largest real
//   exponent and a far-OOD row, whose every exp underflows, still gets a
//   finite m + log(s) with s >= 1. Rows past B are never written.
// Shared memory: 16 KB a block (32 KB at d = 7, 8, two k steps); 80
// registers at d = 5.
//
// Any d: a wider d takes the general kernel, one row per thread, which
// accumulates the cross terms of a 32-reference tile in registers over
// 32-feature chunks of x and the references staged in shared memory (21
// KB), in fp32 on the CUDA cores. Ragged B and N need no padding copies.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stamps.cuh"

namespace {

constexpr int kThreads = 128;
constexpr double kLog2e = 1.4426950408889634;
constexpr float kLn2 = 0.69314718055994531f;

// register path (d <= 8)
constexpr int kQB = 2;                    // 16-row A operands of a warp
constexpr int kTT = 4;                    // 8-reference tiles of a group
constexpr int kWarpRows = 16 * kQB;       // queries of a warp
constexpr int kBlockRows = kThreads / 32 * kWarpRows;
constexpr int kTile = 256;                // references per staged tile
constexpr float kPad = -1e30f;            // a padded reference's exponent
// general path
constexpr int kGenTile = 32;  // references per tile (and per group)
constexpr int kGenChunk = 32; // features per staged chunk

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Fold a group of base-2 exponents (each <= 0, -inf or kPad for padding,
// at least one finite while m is -inf) into the running max m and sum s.
template <int G>
__device__ __forceinline__ void lse_update(float& m, float& s,
                                           const float (&e)[G]) {
  float gm = e[0];
#pragma unroll
  for (int j = 1; j < G; ++j) gm = fmaxf(gm, e[j]);
  // once the max has settled, a group rarely raises it: the branch is
  // taken for the warp as a whole (ex2(-inf) = 0 clears the m = -inf start)
  if (__any_sync(0xffffffffu, gm > m)) {
    const float mn = fmaxf(m, gm);
    if (gm > m) s *= ex2(m - mn);
    m = mn;
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) acc += ex2(e[j] - m);
  s += acc;
}

// The TF32 head of v (cvt.rna), as its bits.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = head + tail, both TF32: the tail keeps the 13 bits the head drops.
__device__ __forceinline__ void split(float v, uint32_t& head,
                                      uint32_t& tail) {
  head = tf32(v);
  tail = tf32(v - __uint_as_float(head));
}

// d += a (16 x 8, row) b (8 x 8, col), TF32 operands, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = D <= 8, in KS = ceil((D + 2) / 8) k steps of 8. Warp w of block b
// owns queries b * kBlockRows + w * kWarpRows + [0, kWarpRows): query block qb
// (16 rows) is an m16n8k8 A operand, lane (gid, tig) holding rows gid and
// gid + 8, features tig and tig + 4 of each k step (and their C values at
// columns 2 tig, 2 tig + 1 of each 8 references).
template <int D>
__global__ void __launch_bounds__(kThreads, (D + 9) / 8 == 1 ? 4 : 2)
    kde_small_kernel(const float* __restrict__ x, long long B,
                     const float* __restrict__ y, int N, float g2,
                     float* __restrict__ out) {
  constexpr int KS = (D + 2 + 7) / 8;
  // B fragments: [8-reference tile][k step][lane], {head b0, head b1,
  // tail b0, tail b1}
  __shared__ float4 sy[kTile / 8 * KS * 32];

  STAMP_BEGIN(true, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long long wrow0 =
      static_cast<long long>(blockIdx.x) * kBlockRows + warp * kWarpRows;
  uint32_t ah[kQB][KS][4], at[kQB][KS][4];
#pragma unroll
  for (int qb = 0; qb < kQB; ++qb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = wrow0 + qb * 16 + gid + 8 * h;
      const float* xr = x + row * D;
      float x2 = 0.f;
      if (row < B) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float v = __ldg(xr + k);
          x2 = fmaf(v, v, x2);
        }
      }
      // feature k of x' = [x, 1, -g2 |x|^2, 0...] (zeros past B)
      const auto xp = [&](int k) {
        if (row >= B) return 0.f;
        return k < D ? __ldg(xr + k)
                     : k == D ? 1.f : k == D + 1 ? -g2 * x2 : 0.f;
      };
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        split(xp(8 * ks + tig), ah[qb][ks][h], at[qb][ks][h]);
        split(xp(8 * ks + tig + 4), ah[qb][ks][2 + h], at[qb][ks][2 + h]);
      }
    }
  }
  float m[kQB][2], s[kQB][2];
#pragma unroll
  for (int qb = 0; qb < kQB; ++qb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[qb][h] = -INFINITY;
      s[qb][h] = 0.f;
    }

  for (int t0 = 0; t0 < N; t0 += kTile) {
    STAMP(1);
    const int nt = min(kTile, N - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      // y' = [2 g2 y, -g2 |y|^2, 1, 0...]; a padded reference: kPad alone
      float yp[8 * KS];
#pragma unroll
      for (int k = 0; k < 8 * KS; ++k) yp[k] = 0.f;
      if (j < nt) {
        const float* yj = y + static_cast<long long>(t0 + j) * D;
        float y2 = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float v = __ldg(yj + k);
          y2 = fmaf(v, v, y2);
          yp[k] = 2.f * g2 * v;
        }
        yp[D] = -g2 * y2;
        yp[D + 1] = 1.f;
      } else {
        yp[D] = kPad;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int tg = 0; tg < 4; ++tg) {
          uint32_t h0, t0b, h1, t1b;
          split(yp[8 * ks + tg], h0, t0b);
          split(yp[8 * ks + tg + 4], h1, t1b);
          sy[((j / 8) * KS + ks) * 32 + (j % 8) * 4 + tg] =
              make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(t0b), __uint_as_float(t1b));
        }
    }
    __syncthreads();

    // groups of kTT 8-reference tiles; tiles past nt hold padding only
    const int groups = (nt + 8 * kTT - 1) / (8 * kTT);
    for (int g = 0; g < groups; ++g) {
      STAMP(2);
      float c[kQB][kTT][4];
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) {
        uint32_t bh[KS][2], bt[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const float4 q = sy[((kTT * g + tt) * KS + ks) * 32 + lane];
          bh[ks][0] = __float_as_uint(q.x);
          bh[ks][1] = __float_as_uint(q.y);
          bt[ks][0] = __float_as_uint(q.z);
          bt[ks][1] = __float_as_uint(q.w);
        }
#pragma unroll
        for (int qb = 0; qb < kQB; ++qb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c[qb][tt][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma_tf32(c[qb][tt], at[qb][ks], bh[ks][0], bh[ks][1]);
            mma_tf32(c[qb][tt], ah[qb][ks], bt[ks][0], bt[ks][1]);
          }
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma_tf32(c[qb][tt], ah[qb][ks], bh[ks][0], bh[ks][1]);
        }
      }
      STAMP(3);
#pragma unroll
      for (int qb = 0; qb < kQB; ++qb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float e[2 * kTT];
#pragma unroll
          for (int tt = 0; tt < kTT; ++tt) {
            e[2 * tt] = fminf(c[qb][tt][2 * h], 0.f);
            e[2 * tt + 1] = fminf(c[qb][tt][2 * h + 1], 0.f);
          }
          lse_update(m[qb][h], s[qb][h], e);
        }
    }
  }

  STAMP(4);
  // the four lanes of a row (tig 0..3) merge their (m, s)
#pragma unroll
  for (int qb = 0; qb < kQB; ++qb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mm = m[qb][h], ss = s[qb][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, mm, off);
        const float so = __shfl_xor_sync(0xffffffffu, ss, off);
        const float mn = fmaxf(mm, mo);
        ss = ss * ex2(mm - mn) + so * ex2(mo - mn);
        mm = mn;
      }
      const long long row = wrow0 + qb * 16 + gid + 8 * h;
      if (tig == 0 && row < B) out[row] = fmaf(mm, kLn2, logf(ss));
    }
  STAMP_END();
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
  const long long blocks = (B + kBlockRows - 1) / kBlockRows;
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

STAMPS_READER(kde)
