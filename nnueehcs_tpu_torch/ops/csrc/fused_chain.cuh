// Device pieces shared by the fused eval kernels (fused_ensemble.cu,
// fused_mc_dropout.cu, fused_anchored.cu): a block of 256 threads owns a
// 64-row tile and runs a BatchNorm-folded Linear(+ReLU) chain over it, many
// times (members, dropout samples, anchors), with the activations in shared
// memory and the weights streamed through it.
//
// - Activations are feature-major in shared memory: element (feature k,
//   row r) of a tile is at k * kStride + r.
// - x is staged into shared memory 32 feature columns at a time, beside the
//   matching chunk of layer 0's weights, so the input may be any width.
// - Each thread owns a 4-row x 8-column register tile, so one k step costs
//   three 16-byte shared loads for 32 FMAs, and a warp's loads fall on
//   distinct banks.
// - Each (K, 128) weight matrix streams through shared memory in 32-row
//   chunks, double-buffered with cp.async.
// - The last layer is computed as dot products over its real columns only
//   and feeds the shifted sums c, s1, s2; each (row, column) slot of those
//   sums is owned by one thread for every pass, so they need no
//   synchronisation.
// Products are true fp32 FFMAs (no TF32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fused_chain {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;            // rows per block
constexpr int kStride = kTileRows + 4;   // activation row stride (floats);
                                         // +4 spreads epilogue stores over banks
constexpr int kWidth = 128;              // padded layer width
constexpr int kChunk = 32;               // weight rows per streamed chunk

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start copying rows [k0, k0 + rows) of a (K, 128) weight matrix into dst.
__device__ __forceinline__ void load_chunk(float* dst, const float* w, int k0,
                                           int rows) {
  constexpr int kQuads = kWidth / 4;
  const int n = rows * kQuads;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / kQuads, q = i % kQuads;
    cp_async16(dst + r * kWidth + q * 4,
               w + static_cast<size_t>(k0 + r) * kWidth + q * 4);
  }
}

// Stream a (K, 128) weight matrix through the two chunk buffers in sw. For
// chunk c (rows [k0, k0 + rows) of w), stage(c, k0, rows) runs while the
// copy lands, then compute(weights, c, k0, rows) once every thread sees it.
// Every thread has finished reading the activations when this returns, so
// a layer may write its output over its input.
template <class S, class F>
__device__ __forceinline__ void stream_weights(float* sw, const float* w,
                                               int K, S&& stage, F&& compute) {
  const int nchunks = (K + kChunk - 1) / kChunk;
  load_chunk(sw, w, 0, min(kChunk, K));
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      const int k1 = (c + 1) * kChunk;
      load_chunk(sw + ((c + 1) & 1) * kChunk * kWidth, w, k1,
                 min(kChunk, K - k1));
    }
    cp_async_commit();  // may be empty: "all but one" then still means chunk c
    const int k0 = c * kChunk, rows = min(kChunk, K - k0);
    stage(c, k0, rows);
    cp_async_wait_all_but_one();
    __syncthreads();
    compute(sw + (c & 1) * kChunk * kWidth, c, k0, rows);
    __syncthreads();  // buffers of slot c & 1 are refilled two chunks later
  }
}

// A value transform v -> f(row in tile, column, v): an input element of x
// as it is staged, or an output element after bias and ReLU. Identity here.
struct Identity {
  __device__ __forceinline__ float operator()(int, int, float v) const {
    return v;
  }
};

// out[n][r] = epi(r, n, act(sum_k in[k][r] * w[k][n] + b[n])) for the tile's
// 64 rows and all 128 (padded) columns n. in/out are feature-major (row
// stride kStride) and may be the same buffer; w is a (K, 128) folded weight
// in device memory. With kFromX (layer 0), the input is the tile's rows of
// x, (valid, K) row-major in device memory: each chunk of K is staged,
// through xform, into one of two kChunk-row slots of `in` (rows past
// `valid` as zeros) beside its weights.
template <bool kFromX, class XForm, class Epi>
__device__ __forceinline__ void dense_layer(float* in, float* out, float* sw,
                                            const float* w, const float* b,
                                            int K, bool relu, const float* x,
                                            int valid, const XForm& xform,
                                            const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty*4 .. ty*4+3
  const int tx = (warp & 1) * 8 + (lane & 7);    // columns tx*4.. and 64+tx*4..
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const auto stage = [&](int c, int k0, int rows) {
    if (!kFromX) return;
    float* dst = in + (c & 1) * kChunk * kStride;
    for (int i = threadIdx.x; i < kTileRows * rows; i += kThreads) {
      const int r = i / rows, k = i - r * rows;
      dst[k * kStride + r] =
          r < valid
              ? xform(r, k0 + k, __ldg(x + static_cast<size_t>(r) * K + k0 + k))
              : 0.f;
    }
  };
  stream_weights(sw, w, K, stage, [&](const float* wc, int c, int k0,
                                      int rows) {
    const float* a = kFromX ? in + (c & 1) * kChunk * kStride
                            : in + k0 * kStride;
#pragma unroll 8
    for (int kk = 0; kk < rows; ++kk) {
      const float4 h =
          *reinterpret_cast<const float4*>(a + kk * kStride + ty * 4);
      const float4 w0 =
          *reinterpret_cast<const float4*>(wc + kk * kWidth + tx * 4);
      const float4 w1 =
          *reinterpret_cast<const float4*>(wc + kk * kWidth + 64 + tx * 4);
      const float hv[4] = {h.x, h.y, h.z, h.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
    }
  });

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
    const float bj = __ldg(b + col);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[i][j] + bj;
      if (relu) v[i] = fmaxf(v[i], 0.f);
      v[i] = epi(ty * 4 + i, col, v[i]);
    }
    *reinterpret_cast<float4*>(out + col * kStride + ty * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Last layer of one pass, real columns only, folded straight into the
// shifted sums: the first pass sets the shift c, every later one adds
// (h - c) to s1 and (h - c)^2 to s2. Slot e = col * kTileRows + row belongs
// to the same thread for every pass. Input element (k, r) is
// xform(r, k, in[k * k_step + r * r_step]): the feature-major activations,
// or x itself when the network is one Linear. Rows past `valid` are never
// written out, so they are skipped.
template <class XForm>
__device__ __forceinline__ void last_layer_stats(
    const float* in, int k_step, int r_step, int valid, const float* w,
    const float* b, int K, bool relu, int out_dim, bool first, float* sc,
    float* s1, float* s2, const XForm& xform) {
  const int n = kTileRows * out_dim;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int col = e / kTileRows, r = e % kTileRows;
    if (r >= valid) continue;
    const float* a = in + static_cast<size_t>(r) * r_step;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(xform(r, k, a[static_cast<size_t>(k) * k_step]),
                 __ldg(w + k * kWidth + col), acc);
    float v = acc + __ldg(b + col);
    if (relu) v = fmaxf(v, 0.f);
    if (first) {
      sc[e] = v;
      s1[e] = 0.f;
      s2[e] = 0.f;
    } else {
      const float dlt = v - sc[e];
      s1[e] += dlt;
      s2[e] += dlt * dlt;
    }
  }
}

// mean = c + s1/n and std = sqrt(max(s2 - n*m1^2, 0)/max(n-1, 1)) with
// m1 = s1/n, for the tile's valid rows; mean/std are (B, out_dim). n*m1^2
// is rounded before the subtraction, as the plain version rounds it: a
// fused multiply-add there would leave s2's own rounding error, so with
// one sample (s2 = m1^2) std would come out sqrt(that error), not 0.
__device__ __forceinline__ void write_stats(const float* sc, const float* s1,
                                            const float* s2, int count,
                                            int valid, long long row0,
                                            int out_dim, float* mean,
                                            float* std) {
  const float n = static_cast<float>(count);
  const float dof = static_cast<float>(count > 1 ? count - 1 : 1);
  for (int e = threadIdx.x; e < kTileRows * out_dim; e += kThreads) {
    const int col = e / kTileRows, r = e % kTileRows;
    if (r < valid) {
      const float m1 = s1[e] / n;
      const float var =
          fmaxf(__fsub_rn(s2[e], __fmul_rn(__fmul_rn(n, m1), m1)), 0.f) / dof;
      const size_t o = static_cast<size_t>(row0 + r) * out_dim + col;
      mean[o] = sc[e] + m1;
      std[o] = sqrtf(var);
    }
  }
}

// Shared memory of a kernel with two (128, kStride) activation buffers, the
// two weight chunk buffers and the shifted sums.
inline size_t smem_bytes(int out_dim) {
  return sizeof(float) * (2 * kWidth * kStride + 2 * kChunk * kWidth +
                          3 * kTileRows * out_dim);
}

}  // namespace fused_chain
