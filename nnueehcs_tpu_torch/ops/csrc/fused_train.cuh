// The configuration, arguments, dropout hash and optimizer of the fused
// whole-epoch training kernel (kernel 3). The step itself is the cluster
// form in fused_train_cluster.cuh, which fused_train.cu (fp32),
// fused_train_bf16.cu (bf16-mixed) and the attribution probe
// (ablate_train.cu) drive; adam_kernel below is the third launch of each
// step.
//
// Everything here has internal linkage (an unnamed namespace): each .cu file
// that includes it compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;      // padded layer width
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
  float* scratch;     // per member: train_layout's member_floats
  float* preds;       // (M, B, 128): the loss sweep's predictions
  float* terms;       // (M): loss-term sums
  float* partials;    // (M): sums of g^2 per member slab
  unsigned char* signs;  // optional (S, M, n_bn, B, 128): ReLU decisions
  // optional one-element device values (null: the host configuration):
  // the learning rate the optimizer reads in place of f[kLr], and a flag
  // that, when nonzero, makes every launch of the epoch return at once
  const float* lr_dev;
  const int* stop;
  // the attribution probe's (null in the production kernels, which never
  // read them): the step index base of a replayed graph (a launch's step
  // is *step_base + its own index), each step's global gradient norm, and
  // the count of the step's clusters that have handed on their sums
  const int* step_base;
  float* norms;
  unsigned* norm_count;
};

// True when the launch is one of a stopped epoch's: it must return before
// it reads or writes anything (in a cluster kernel, before its first
// cluster barrier; every block reads the same value, so all return).
__device__ __forceinline__ bool stopped(const Args& A) {
  return A.stop != nullptr && *A.stop != 0;
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

__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
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
  const float lr = A.lr_dev != nullptr ? *A.lr_dev : A.f[kLr];
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
  A.lr_dev = nullptr;
  A.stop = nullptr;
  A.step_base = nullptr;
  A.norms = nullptr;
  A.norm_count = nullptr;
  return A;
}

// The step index of launch `u` of an epoch: u itself in the production
// kernels; in the probe's forms (kProbe), *step_base + u when step_base is
// set (the launches of a CUDA graph that the probe replays).
template <bool kProbe>
__device__ __forceinline__ int step_index(const Args& A, int u) {
  if constexpr (kProbe) return A.step_base != nullptr ? *A.step_base + u : u;
  else return u;
}

template <bool kProbe = false>
__global__ void __launch_bounds__(kOptThreads) adam_kernel(Args A, int u) {
  if (stopped(A)) return;
  adam_step(A, step_index<kProbe>(A, u));
}

// Blocks of adam_kernel: a grid-stride loop over at most 1,024 blocks.
inline unsigned adam_blocks(long long n) {
  const long long blocks = (n + kOptThreads - 1) / kOptThreads;
  return static_cast<unsigned>(blocks > 1024 ? 1024 : blocks);
}

}  // namespace
