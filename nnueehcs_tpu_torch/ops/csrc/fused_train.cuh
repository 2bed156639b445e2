// Device code of the fused whole-epoch training kernel (kernel 3): shared by
// fused_train.cu, the production entry, and ablate_train.cu, the attribution
// probe of the same kernel, so the probe's control runs this very code.
//
// What it computes, what bounds it and how it is laid out: see
// fused_train.cu. One step is two or three launches of the kernels at the
// end of this file (loss_sweep_kernel, member_step_kernel, adam_kernel);
// each is a thin shell around a __forceinline__ body (loss_sweep,
// member_step, adam_step) that the probe's variants reuse.
//
// Everything here has internal linkage (an unnamed namespace): each .cu file
// that includes it compiles its own copy.
//
// The bodies are templates on their shared-memory type: with Smem they run
// the fp32 block_gemm below; with fused_train_bf16.cuh's SmemBf16 the same
// bodies run its bf16 block_gemm overload (found by argument-dependent
// lookup when they are instantiated), and nothing else changes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 128;       // rows per GEMM tile
constexpr int kLanes = 128;      // padded layer width
constexpr int kK = 32;           // reduction steps per staged chunk
constexpr int kAStride = kTile + 4;
constexpr int kBStride = kLanes + 4;
constexpr int kOptThreads = 256;

// int configuration, in the order of fused_train.py's INT_FIELDS
enum {
  kS, kB, kInPad, kOutPad, kM, kSlabRows, kSigRows, kNLins, kNBn, kNDrop,
  kLoss, kSingleSweep, kClipOn, kStep0, kSeed, kHasWd, kNumInts
};
// float configuration, in the order of FLOAT_FIELDS
enum {
  kLr, kBnEps, kMom, kOneMinusMom, kUnbias, kInvMembers, kLossDiv,
  kSweepDiv, kClip, kWd, kB1, kB2, kOneMinusB1, kOneMinusB2, kAdamEps,
  kLnB1, kLnB2, kNumFloats
};
// one row of the block table, in the order of LIN_FIELDS
enum {
  kWOff, kInRows, kInW, kOutW, kBOff, kGOff, kBeOff, kMeanOff, kVarOff,
  kZhIdx, kRelu, kMaskIdx, kLinFields
};
enum { kL1 = 0, kMse = 1, kNll = 2 };

struct Args {
  long long i[kNumInts];
  float f[kNumFloats];
  float* theta;
  float* m;
  float* v;
  float* sigma;
  float* g;
  const float* xs;
  const float* ys;
  float* losses;
  const int* lins;
  const float* drops;
  float* scratch;     // per member: scratch_floats(B, n_bn, n_drop)
  float* preds;       // (M, B, 128): the loss sweep's predictions
  float* terms;       // (M): loss-term sums
  float* partials;    // (M): sums of g^2 per member slab
  unsigned char* signs;  // optional (S, M, n_bn, B, 128): ReLU decisions
};

__host__ __device__ long long scratch_floats(long long B, long long n_bn,
                                             long long n_drop) {
  // h, z, d, d2, a; x-hat per BN; 1/sigma per BN; one mask per slot
  return 5 * B * kLanes + n_bn * B * kLanes + n_bn * kLanes +
         (n_drop > 0 ? n_drop : 1) * B * kLanes;
}

struct Smem {
  float as[kK][kAStride];
  float bs[kK][kBStride];
  float red[4][4][kLanes];   // partial column sums: [part][sum][column]
  float col[4][kLanes];      // column sums
  float warp[kThreads / 32];
};

// Scratch of one member.
struct Member {
  float* h;
  float* z;
  float* d;
  float* d2;
  float* a;
  float* zh;     // (n_bn, B, 128)
  float* inv;    // (n_bn, 128)
  float* mask;   // (slots, B, 128)
};

__device__ Member member_scratch(const Args& A, int m) {
  const long long B = A.i[kB];
  float* base = A.scratch + m * scratch_floats(B, A.i[kNBn], A.i[kNDrop]);
  const long long tile = B * kLanes;
  Member s;
  s.h = base;
  s.z = base + tile;
  s.d = base + 2 * tile;
  s.d2 = base + 3 * tile;
  s.a = base + 4 * tile;
  s.zh = base + 5 * tile;
  s.inv = s.zh + A.i[kNBn] * tile;
  s.mask = s.inv + A.i[kNBn] * kLanes;
  return s;
}

// c (rows x 128, row stride 128) = A (rows x K) * Bm (K x 128) (+ bias),
// with A(r, k) = a[r * a_rs + k * a_ks] and Bm(k, n) = b[k * b_ks + n * b_cs].
// Either stride of each operand is 1; staging walks the contiguous one.
// With kSq, each thread also adds the squares of the values it writes to
// its own sq (one float&); production passes none.
template <bool kSq = false, class... Sq>
__device__ void block_gemm(int rows, int K, const float* a, long long a_rs,
                           long long a_ks, const float* b, long long b_ks,
                           long long b_cs, const float* bias, float* c,
                           Smem& sm, Sq&... sq) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty*4 .. ty*4+3
  const int tx = (warp & 1) * 8 + (lane & 7);    // columns tx*4.. and 64+tx*4..
  for (int r0 = 0; r0 < rows; r0 += kTile) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kK) {
      for (int e = tid; e < kTile * kK; e += kThreads) {
        int r, kk;
        if (a_ks == 1) {
          r = e / kK;
          kk = e % kK;
        } else {
          kk = e / kTile;
          r = e % kTile;
        }
        const int gr = r0 + r, gk = k0 + kk;
        sm.as[kk][r] = (gr < rows && gk < K) ? a[gr * a_rs + gk * a_ks] : 0.f;
      }
      for (int e = tid; e < kLanes * kK; e += kThreads) {
        int n, kk;
        if (b_cs == 1) {
          kk = e / kLanes;
          n = e % kLanes;
        } else {
          n = e / kK;
          kk = e % kK;
        }
        const int gk = k0 + kk;
        sm.bs[kk][n] = gk < K ? b[gk * b_ks + n * b_cs] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        const float4 h = *reinterpret_cast<const float4*>(&sm.as[kk][ty * 4]);
        const float4 w0 = *reinterpret_cast<const float4*>(&sm.bs[kk][tx * 4]);
        const float4 w1 =
            *reinterpret_cast<const float4*>(&sm.bs[kk][64 + tx * 4]);
        const float hv[4] = {h.x, h.y, h.z, h.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
        const float v = bias ? __fadd_rn(acc[i][j], bias[n]) : acc[i][j];
        c[static_cast<long long>(r) * kLanes + n] = v;
        if constexpr (kSq) ((sq = __fadd_rn(sq, __fmul_rn(v, v))), ...);
      }
    }
  }
  __syncthreads();
}

// sm.col[s][n] = sum over rows r of f(r, n)[s], s < N, in a fixed order:
// four threads per column sum every fourth row, then one adds the four.
template <int N, class F, class Sm>
__device__ void col_sums(int rows, F f, Sm& sm) {
  const int n = threadIdx.x & (kLanes - 1), part = threadIdx.x >> 7;
  float acc[N];
#pragma unroll
  for (int s = 0; s < N; ++s) acc[s] = 0.f;
  for (int r = part; r < rows; r += kThreads / kLanes) {
    float val[N];
    f(r, n, val);
#pragma unroll
    for (int s = 0; s < N; ++s) acc[s] = __fadd_rn(acc[s], val[s]);
  }
#pragma unroll
  for (int s = 0; s < N; ++s) sm.red[part][s][n] = acc[s];
  __syncthreads();
  if (threadIdx.x < kLanes) {
#pragma unroll
    for (int s = 0; s < N; ++s)
      sm.col[s][n] = __fadd_rn(__fadd_rn(__fadd_rn(sm.red[0][s][n],
                                                   sm.red[1][s][n]),
                                         sm.red[2][s][n]),
                               sm.red[3][s][n]);
  }
  __syncthreads();
}

// The block's sum of one value per thread, in a fixed order; every thread
// gets it.
template <class Sm>
__device__ float block_sum(float v, Sm& sm) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sm.warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, sm.warp[w]);
  __syncthreads();
  return total;
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The dropout multiplier (1/keep or 0) of element (r, c) of a mask slot.
__device__ __forceinline__ float mask_value(uint32_t salt, int r, int c,
                                            float keep, float inv_keep) {
  const uint32_t x = lowbias32(salt * 0x9E3779B9u +
                               static_cast<uint32_t>(r) * 0x85EBCA6Bu +
                               static_cast<uint32_t>(c) * 0xC2B2AE35u);
  const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  return u < keep ? inv_keep : 0.f;
}

__device__ __forceinline__ uint32_t mask_salt(const Args& A, int step, int m,
                                              int slot) {
  return static_cast<uint32_t>(A.i[kSeed]) +
         static_cast<uint32_t>(step) * 1225253u +
         static_cast<uint32_t>(m) * 131071u +
         static_cast<uint32_t>(slot) * 524287u;
}

__device__ __forceinline__ const int* lin_row(const Args& A, int li) {
  return A.lins + li * kLinFields;
}

// One member's training-mode forward at step `step` with the running-stat
// EMA; the output (B x 128) is left in s.h, and x-hat, 1/sigma and the
// masks are kept for the backward.
template <class Sm>
__device__ void member_forward(const Args& A, int step, int m,
                               const Member& s, Sm& sm) {
  const int B = static_cast<int>(A.i[kB]);
  const int in_pad = static_cast<int>(A.i[kInPad]);
  const long long base = m * A.i[kSlabRows], sbase = m * A.i[kSigRows];
  const float* x = A.xs + static_cast<long long>(step) * B * in_pad;
  const float* hin = x;
  int ld = in_pad;
  const float fB = static_cast<float>(B);
  for (int li = 0; li < A.i[kNLins]; ++li) {
    const int* L = lin_row(A, li);
    const int K = L[kInRows];
    if (L[kMaskIdx] >= 0) {
      const int slot = L[kMaskIdx];
      const float keep = __fsub_rn(1.0f, A.drops[slot]);
      const float inv_keep = __fdiv_rn(1.0f, keep);
      const uint32_t salt = mask_salt(A, step, m, slot);
      float* dst = hin == x ? s.a : s.h;   // x itself is read-only
      for (int e = threadIdx.x; e < B * K; e += kThreads) {
        const int r = e / K, c = e % K;
        const float mk = mask_value(salt, r, c, keep, inv_keep);
        s.mask[(static_cast<long long>(slot) * B + r) * kLanes + c] = mk;
        dst[r * ld + c] = __fmul_rn(hin[r * ld + c], mk);
      }
      __syncthreads();
      hin = dst;
    }
    const float* W = A.theta + (base + L[kWOff]) * kLanes;
    block_gemm(B, K, hin, ld, 1, W, kLanes, 1,
               A.theta + (base + L[kBOff]) * kLanes, s.z, sm);
    const bool relu = L[kRelu] != 0;
    if (L[kGOff] >= 0) {
      col_sums<1>(B, [&](int r, int n, float* val) { val[0] = s.z[r * kLanes + n]; }, sm);
      const float mu = __fdiv_rn(sm.col[0][threadIdx.x & (kLanes - 1)], fB);
      __syncthreads();
      col_sums<1>(B, [&](int r, int n, float* val) {
        const float c = __fsub_rn(s.z[r * kLanes + n], __fdiv_rn(sm.col[0][n], fB));
        val[0] = __fmul_rn(c, c);
      }, sm);
      // sm.col[0] now holds the sums of squares; mu was kept per thread
      // for column (tid & 127), so recompute the means in shared memory
      if (threadIdx.x < kLanes) {
        const int n = threadIdx.x;
        const float var = __fdiv_rn(sm.col[0][n], fB);
        const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, A.f[kBnEps])));
        sm.col[1][n] = mu;
        sm.col[2][n] = inv;
        s.inv[L[kZhIdx] * kLanes + n] = inv;
        float* mo = A.sigma + (sbase + L[kMeanOff]) * kLanes;
        float* vo = A.sigma + (sbase + L[kVarOff]) * kLanes;
        mo[n] = __fadd_rn(__fmul_rn(A.f[kOneMinusMom], mo[n]),
                          __fmul_rn(A.f[kMom], mu));
        vo[n] = __fadd_rn(__fmul_rn(A.f[kOneMinusMom], vo[n]),
                          __fmul_rn(A.f[kMom], __fmul_rn(var, A.f[kUnbias])));
      }
      __syncthreads();
      const float* gam = A.theta + (base + L[kGOff]) * kLanes;
      const float* bet = A.theta + (base + L[kBeOff]) * kLanes;
      float* zh = s.zh + static_cast<long long>(L[kZhIdx]) * B * kLanes;
      for (int e = threadIdx.x; e < B * kLanes; e += kThreads) {
        const int n = e & (kLanes - 1);
        const float xh = __fmul_rn(__fsub_rn(s.z[e], sm.col[1][n]), sm.col[2][n]);
        zh[e] = xh;
        float hv = __fadd_rn(__fmul_rn(xh, gam[n]), bet[n]);
        if (relu) hv = fmaxf(hv, 0.f);
        s.h[e] = hv;
      }
    } else {
      for (int e = threadIdx.x; e < B * kLanes; e += kThreads) {
        float hv = s.z[e];
        if (relu) hv = fmaxf(hv, 0.f);
        s.h[e] = hv;
      }
    }
    __syncthreads();
    hin = s.h;
    ld = kLanes;
  }
}

__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// Loss terms of `pred` (B x 128) against the step's targets: writes
// dL/dpred / div * inv_members into d and returns the block's term sum.
template <class Sm>
__device__ float loss_and_grad(const Args& A, int step, const float* pred,
                               float* d, Sm& sm) {
  const int B = static_cast<int>(A.i[kB]);
  const int out_pad = static_cast<int>(A.i[kOutPad]);
  const float* y = A.ys + static_cast<long long>(step) * B * out_pad;
  const float div = A.f[kLossDiv], inv_m = A.f[kInvMembers];
  const int out_w = lin_row(A, static_cast<int>(A.i[kNLins]) - 1)[kOutW];
  float term = 0.f;
  if (A.i[kLoss] == kNll) {
    for (int e = threadIdx.x; e < B * kLanes; e += kThreads) d[e] = 0.f;
    __syncthreads();
    for (int r = threadIdx.x; r < B; r += kThreads) {
      const float raw = pred[r * kLanes + 1];
      const float var = __fadd_rn(softplus(raw), 1e-6f);
      const float inv = __fdiv_rn(1.0f, var);
      const float diff = __fsub_rn(pred[r * kLanes], y[r * out_pad]);
      const float sq = __fmul_rn(diff, diff);
      term = __fadd_rn(term, __fadd_rn(__fmul_rn(0.5f, logf(var)),
                                       __fmul_rn(__fmul_rn(0.5f, sq), inv)));
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-raw)));
      d[r * kLanes] = __fmul_rn(__fdiv_rn(__fmul_rn(diff, inv), div), inv_m);
      const float dr = __fsub_rn(inv, __fmul_rn(__fmul_rn(sq, inv), inv));
      d[r * kLanes + 1] = __fmul_rn(
          __fdiv_rn(__fmul_rn(__fmul_rn(0.5f, dr), sig), div), inv_m);
    }
  } else {
    for (int e = threadIdx.x; e < B * kLanes; e += kThreads) {
      const int r = e / kLanes, n = e & (kLanes - 1);
      const float yv = n < out_pad ? y[r * out_pad + n] : 0.f;
      const float diff = __fsub_rn(pred[e], yv);
      float gv;
      if (A.i[kLoss] == kL1) {
        term = __fadd_rn(term, fabsf(diff));
        const float lane = n < out_w ? 1.f : 0.f;
        gv = __fdiv_rn(diff >= 0.f ? lane : -lane, div);
      } else {
        term = __fadd_rn(term, __fmul_rn(diff, diff));
        gv = __fdiv_rn(__fmul_rn(2.0f, diff), div);
      }
      d[e] = __fmul_rn(gv, inv_m);
    }
  }
  const float total = block_sum(term, sm);
  return total;
}

// The reverse pass of member m at step `step` from d = dL/d(output); writes
// the member's gradient rows of g. With kSq, each thread adds the squares of
// the gradient values it writes to its sq (one float&).
template <bool kSq = false, class Sm, class... Sq>
__device__ void member_backward(const Args& A, int step, int m,
                                const Member& s, Sm& sm, Sq&... sq) {
  const int B = static_cast<int>(A.i[kB]);
  const int in_pad = static_cast<int>(A.i[kInPad]);
  const long long base = m * A.i[kSlabRows];
  const float* x = A.xs + static_cast<long long>(step) * B * in_pad;
  const float fB = static_cast<float>(B);
  float* d = s.d;
  float* d2 = s.d2;
  for (int li = static_cast<int>(A.i[kNLins]) - 1; li >= 0; --li) {
    const int* L = lin_row(A, li);
    const float* gam = L[kGOff] >= 0 ? A.theta + (base + L[kGOff]) * kLanes : nullptr;
    const float* bet = L[kGOff] >= 0 ? A.theta + (base + L[kBeOff]) * kLanes : nullptr;
    const float* zh = L[kZhIdx] >= 0 ? s.zh + static_cast<long long>(L[kZhIdx]) * B * kLanes
                                     : nullptr;
    if (L[kRelu]) {
      unsigned char* sg = A.signs ? A.signs + ((static_cast<long long>(step) * A.i[kM] + m) *
                                                   A.i[kNBn] + L[kZhIdx]) * B * kLanes
                                  : nullptr;
      for (int e = threadIdx.x; e < B * kLanes; e += kThreads) {
        const int n = e & (kLanes - 1);
        const float act = __fadd_rn(__fmul_rn(zh[e], gam[n]), bet[n]);
        if (sg) sg[e] = act > 0.f;
        d[e] = __fmul_rn(d[e], act > 0.f ? 1.f : 0.f);
      }
      __syncthreads();
    }
    if (L[kGOff] >= 0) {
      col_sums<4>(B, [&](int r, int n, float* val) {
        const float dv = d[r * kLanes + n], zv = zh[r * kLanes + n];
        const float dz = __fmul_rn(dv, gam[n]);
        val[0] = __fmul_rn(dv, zv);
        val[1] = dv;
        val[2] = dz;
        val[3] = __fmul_rn(dz, zv);
      }, sm);
      const float* inv = s.inv + L[kZhIdx] * kLanes;
      if (threadIdx.x < kLanes) {
        A.g[(base + L[kGOff]) * kLanes + threadIdx.x] = sm.col[0][threadIdx.x];
        A.g[(base + L[kBeOff]) * kLanes + threadIdx.x] = sm.col[1][threadIdx.x];
        if constexpr (kSq) {
          const float gg = sm.col[0][threadIdx.x], gb = sm.col[1][threadIdx.x];
          ((sq = __fadd_rn(__fadd_rn(sq, __fmul_rn(gg, gg)), __fmul_rn(gb, gb))), ...);
        }
      }
      for (int e = threadIdx.x; e < B * kLanes; e += kThreads) {
        const int n = e & (kLanes - 1);
        const float dz = __fmul_rn(d[e], gam[n]);
        const float t = __fsub_rn(__fsub_rn(__fmul_rn(fB, dz), sm.col[2][n]),
                                  __fmul_rn(zh[e], sm.col[3][n]));
        d[e] = __fmul_rn(__fdiv_rn(inv[n], fB), t);
      }
      __syncthreads();
    }
    // the block's input a, as the forward saw it after its dropout mask
    const int K = L[kInRows];
    const float* a;
    long long lda;
    const float* mk = L[kMaskIdx] >= 0
                          ? s.mask + static_cast<long long>(L[kMaskIdx]) * B * kLanes
                          : nullptr;
    if (li == 0) {
      if (mk) {
        for (int e = threadIdx.x; e < B * K; e += kThreads) {
          const int r = e / K, c = e % K;
          s.a[r * K + c] = __fmul_rn(x[r * in_pad + c], mk[r * kLanes + c]);
        }
        __syncthreads();
        a = s.a;
      } else {
        a = x;
      }
      lda = in_pad;
    } else {
      const int* P = lin_row(A, li - 1);
      const float* pz = s.zh + static_cast<long long>(P[kZhIdx]) * B * kLanes;
      const float* pg = A.theta + (base + P[kGOff]) * kLanes;
      const float* pb = A.theta + (base + P[kBeOff]) * kLanes;
      const bool prelu = P[kRelu] != 0;
      for (int e = threadIdx.x; e < B * kLanes; e += kThreads) {
        const int n = e & (kLanes - 1);
        float av = __fadd_rn(__fmul_rn(pz[e], pg[n]), pb[n]);
        if (prelu) av = fmaxf(av, 0.f);
        if (mk) av = __fmul_rn(av, mk[e]);
        s.a[e] = av;
      }
      __syncthreads();
      a = s.a;
      lda = kLanes;
    }
    // dW = a^T d into rows [w_off, w_off + K) of g
    block_gemm<kSq>(K, B, a, 1, lda, d, kLanes, 1, nullptr,
                    A.g + (base + L[kWOff]) * kLanes, sm, sq...);
    col_sums<1>(B, [&](int r, int n, float* val) { val[0] = d[r * kLanes + n]; }, sm);
    if (threadIdx.x < kLanes) {
      A.g[(base + L[kBOff]) * kLanes + threadIdx.x] = sm.col[0][threadIdx.x];
      if constexpr (kSq) {
        const float gb = sm.col[0][threadIdx.x];
        ((sq = __fadd_rn(sq, __fmul_rn(gb, gb))), ...);
      }
    }
    if (li > 0) {
      // d2 = d W^T (W is K x 128 with K = 128 for a hidden block)
      const float* W = A.theta + (base + L[kWOff]) * kLanes;
      block_gemm(B, kLanes, d, kLanes, 1, W, 1, kLanes, nullptr, d2, sm);
      if (mk) {
        for (int e = threadIdx.x; e < B * kLanes; e += kThreads)
          d2[e] = __fmul_rn(d2[e], mk[e]);
        __syncthreads();
      }
      float* t = d;
      d = d2;
      d2 = t;
    }
    __syncthreads();
  }
}

// Joint mean only: member blockIdx.x's forward, which saves what its
// backward needs in the member's scratch; its prediction goes to preds[m].
template <class Sm>
__device__ __forceinline__ void loss_sweep(const Args& A, int step, Sm& sm) {
  const int m = blockIdx.x;
  const Member s = member_scratch(A, m);
  member_forward(A, step, m, s, sm);
  const long long tile = A.i[kB] * kLanes;
  for (long long e = threadIdx.x; e < tile; e += kThreads)
    A.preds[m * tile + e] = s.h[e];
}

// The joint-mean loss: the mean prediction, summed in member order (as every
// block computes it), into s.z; its loss gradient into s.d. Returns the
// block's loss-term sum.
template <class Sm>
__device__ __forceinline__ float joint_loss(const Args& A, int step,
                                            const Member& s, Sm& sm) {
  const int M = static_cast<int>(A.i[kM]);
  const long long tile = A.i[kB] * kLanes;
  for (long long e = threadIdx.x; e < tile; e += kThreads) {
    float sum = A.preds[e];
    for (int j = 1; j < M; ++j) sum = __fadd_rn(sum, A.preds[j * tile + e]);
    s.z[e] = __fmul_rn(sum, A.f[kInvMembers]);
  }
  __syncthreads();
  return loss_and_grad(A, step, s.z, s.d, sm);
}

// Member blockIdx.x: its loss gradient (the joint one from every member's
// prediction, or, in single-sweep mode, its own after its forward), the
// backward into g, and its sum of g^2 into partials[m]: by a re-read of
// its slab, or, with kSqFused, as the backward writes g (another order).
template <bool kSqFused = false, class Sm>
__device__ __forceinline__ void member_step(const Args& A, int step,
                                            Sm& sm) {
  const int m = blockIdx.x;
  const Member s = member_scratch(A, m);
  if (!A.i[kSingleSweep]) {
    const float term = joint_loss(A, step, s, sm);
    if (m == 0 && threadIdx.x == 0) A.terms[0] = term;
    __syncthreads();
  } else {
    member_forward(A, step, m, s, sm);
    const float term = loss_and_grad(A, step, s.h, s.d, sm);
    if (threadIdx.x == 0) A.terms[m] = term;
    __syncthreads();
  }
  float total;
  if constexpr (kSqFused) {
    float acc = 0.f;
    member_backward<true>(A, step, m, s, sm, acc);
    total = block_sum(acc, sm);
  } else {
    member_backward(A, step, m, s, sm);
    const long long slab = A.i[kSlabRows] * kLanes;
    const float* gs = A.g + m * slab;
    float acc = 0.f;
    for (long long e = threadIdx.x; e < slab; e += kThreads)
      acc = __fadd_rn(acc, __fmul_rn(gs[e], gs[e]));
    total = block_sum(acc, sm);
  }
  if (threadIdx.x == 0) A.partials[m] = total;
}

// Clip by global norm, bias-corrected Adam, decayed weights, theta -= lr*u
// over the flat buffers, a grid-stride loop over whatever grid the launch
// gives; every block adds the members' partial sums in member order, so
// the clip scale is the same everywhere. Block 0 also writes the step's
// loss.
__device__ __forceinline__ void adam_step(const Args& A, int step) {
  __shared__ float s_scale;
  const int M = static_cast<int>(A.i[kM]);
  if (threadIdx.x == 0) {
    float scale = 1.0f;
    if (A.i[kClipOn]) {
      float gn2 = 0.f;
      for (int j = 0; j < M; ++j) gn2 = __fadd_rn(gn2, A.partials[j]);
      const float gn = __fsqrt_rn(gn2);
      scale = gn < A.f[kClip] ? 1.0f : __fdiv_rn(A.f[kClip], gn);
    }
    s_scale = scale;
    if (blockIdx.x == 0) {
      float loss;
      if (A.i[kSingleSweep]) {
        float sum = 0.f;
        for (int j = 0; j < M; ++j) sum = __fadd_rn(sum, A.terms[j]);
        loss = __fdiv_rn(sum, A.f[kSweepDiv]);
      } else {
        loss = __fdiv_rn(A.terms[0], A.f[kLossDiv]);
      }
      A.losses[step] = loss;
    }
  }
  __syncthreads();
  const float scale = s_scale;
  const float t = static_cast<float>(A.i[kStep0] + step + 1);
  const float c1 = __fsub_rn(1.0f, expf(__fmul_rn(t, A.f[kLnB1])));
  const float c2 = __fsub_rn(1.0f, expf(__fmul_rn(t, A.f[kLnB2])));
  const float lr = A.f[kLr];
  const long long n = A.i[kM] * A.i[kSlabRows] * kLanes;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float g = __fmul_rn(A.g[e], scale);
    const float mn = __fadd_rn(__fmul_rn(A.f[kB1], A.m[e]),
                               __fmul_rn(A.f[kOneMinusB1], g));
    const float vn = __fadd_rn(__fmul_rn(A.f[kB2], A.v[e]),
                               __fmul_rn(__fmul_rn(A.f[kOneMinusB2], g), g));
    A.m[e] = mn;
    A.v[e] = vn;
    float u = __fdiv_rn(__fdiv_rn(mn, c1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, c2)), A.f[kAdamEps]));
    if (A.i[kHasWd]) u = __fadd_rn(u, __fmul_rn(A.f[kWd], A.theta[e]));
    A.theta[e] = __fsub_rn(A.theta[e], __fmul_rn(lr, u));
  }
}

// The kernels' arguments from the entry's host arrays: iconf and fconf in
// the order of the int and float enums, then the device buffers; small
// holds terms (M floats) then partials (M floats).
inline Args make_args(const long long* iconf, const float* fconf, float* theta,
                      float* m, float* v, float* sigma, float* g,
                      const float* xs, const float* ys, float* losses,
                      const int* lins, const float* drops, float* scratch,
                      float* preds, float* small, unsigned char* signs) {
  Args A;
  for (int k = 0; k < kNumInts; ++k) A.i[k] = iconf[k];
  for (int k = 0; k < kNumFloats; ++k) A.f[k] = fconf[k];
  A.theta = theta;
  A.m = m;
  A.v = v;
  A.sigma = sigma;
  A.g = g;
  A.xs = xs;
  A.ys = ys;
  A.losses = losses;
  A.lins = lins;
  A.drops = drops;
  A.scratch = scratch;
  A.preds = preds;
  A.terms = small;
  A.partials = small + A.i[kM];
  A.signs = signs;
  return A;
}

// The production step: loss_sweep_kernel (joint mean only), member_step_kernel
// and adam_kernel, one block per member for the first two. A file that
// launches only another form's step (fused_train_bf16.cu) defines
// NNUEEHCS_NO_FP32_STEP first, so its library holds no unlaunched copy.
#ifndef NNUEEHCS_NO_FP32_STEP
__global__ void __launch_bounds__(kThreads, 1) loss_sweep_kernel(Args A, int step) {
  __shared__ __align__(16) Smem sm;
  loss_sweep(A, step, sm);
}

__global__ void __launch_bounds__(kThreads, 1) member_step_kernel(Args A, int step) {
  __shared__ __align__(16) Smem sm;
  member_step(A, step, sm);
}
#endif

__global__ void __launch_bounds__(kOptThreads) adam_kernel(Args A, int step) {
  adam_step(A, step);
}

// Blocks of adam_kernel: a grid-stride loop over at most 1,024 blocks.
inline unsigned adam_blocks(long long n) {
  const long long blocks = (n + kOptThreads - 1) / kOptThreads;
  return static_cast<unsigned>(blocks > 1024 ? 1024 : blocks);
}

// Enqueue the S steps of an epoch on `st`, each the form's loss sweep
// (joint mean only) and member step, then adam_kernel; returns
// cudaGetLastError() (0 on success), read after the first step and at the
// end.
template <void (*Sweep)(Args, int), void (*Step)(Args, int)>
int run_epoch(const Args& A, cudaStream_t st) {
  const unsigned M = static_cast<unsigned>(A.i[kM]);
  const unsigned blocks = adam_blocks(A.i[kM] * A.i[kSlabRows] * kLanes);
  for (int step = 0; step < A.i[kS]; ++step) {
    if (!A.i[kSingleSweep]) Sweep<<<M, kThreads, 0, st>>>(A, step);
    Step<<<M, kThreads, 0, st>>>(A, step);
    adam_kernel<<<blocks, kOptThreads, 0, st>>>(A, step);
    if (step == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
