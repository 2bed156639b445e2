// Device pieces of the FFMA attribution probes of kernel 1 (ablate_chain.cu:
// xt_forward, narrow_forward, the fp32 packed_forward and their control,
// instances of ensemble_pass below, kernel 1's body until it moved to
// fused_chain_wgmma.cuh's 3xTF32 section): a block of 256 threads owns a
// 64-row tile and runs a
// BatchNorm-folded Linear(+ReLU) chain over it once for each member, with
// the activations in shared memory and the weights streamed through it.
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

// Where element (row r of the tile, feature k0 + k: a chunk's first feature,
// then the feature within it) of x lies, from the tile's first element: at
// x[r * rs + (k0 + k) * ks] (a row-major x, or a feature-major one).
struct XStrided {
  long long rs, ks;
  __device__ __forceinline__ const float* operator()(const float* x, int r,
                                                     int k0, int k,
                                                     int) const {
    return x + r * rs + (k0 + k) * ks;
  }
};

// out[n][r] = act(sum_k in[k][r] * w[k][n] + b[n]) for the tile's
// 64 rows and all 128 (padded) columns n. in/out are feature-major (row
// stride kStride) and may be the same buffer; w is a (K, 128) folded weight
// in device memory. With kFromX (layer 0), the input is the tile's rows of
// x, element (r, k0 + k) at at(x, r, k0, k, K) in device memory: each chunk
// of K is staged into one of two kChunk-row slots of `in` (rows past `valid`
// as zeros) beside its weights.
template <bool kFromX>
__device__ __forceinline__ void dense_layer(float* in, float* out, float* sw,
                                            const float* w, const float* b,
                                            int K, bool relu, const float* x,
                                            int valid,
                                            const XStrided& at = XStrided()) {
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
          r < valid ? __ldg(at(x, r, k0, k, K)) : 0.f;
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
    }
    *reinterpret_cast<float4*>(out + col * kStride + ty * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Last layer of one pass, real columns only, folded straight into the
// shifted sums: the first pass sets the shift c, every later one adds
// (h - c) to s1 and (h - c)^2 to s2. Slot e = col * kTileRows + row belongs
// to the same thread for every pass. Input element (k, r) is
// in[k * k_step + r * r_step]: the feature-major activations,
// or x itself when the network is one Linear. Rows past `valid` are never
// written out, so they are skipped.
__device__ __forceinline__ void last_layer_stats(
    const float* in, int k_step, int r_step, int valid, const float* w,
    const float* b, int K, bool relu, int out_dim, bool first, float* sc,
    float* s1, float* s2) {
  const int n = kTileRows * out_dim;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int col = e / kTileRows, r = e % kTileRows;
    if (r >= valid) continue;
    const float* a = in + static_cast<size_t>(r) * r_step;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(a[static_cast<size_t>(k) * k_step],
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

// Slot e's mean = c + s1/n and std = sqrt(max(s2 - n*m1^2, 0)/max(n-1, 1))
// with m1 = s1/n. n*m1^2 is rounded before the subtraction, as the plain
// version rounds it: a fused multiply-add there would leave s2's own
// rounding error, so with one sample (s2 = m1^2) std would come out
// sqrt(that error), not 0.
__device__ __forceinline__ void shifted_stat(const float* sc, const float* s1,
                                             const float* s2, int e, float n,
                                             float dof, float& mean,
                                             float& std) {
  const float m1 = s1[e] / n;
  const float var =
      fmaxf(__fsub_rn(s2[e], __fmul_rn(__fmul_rn(n, m1), m1)), 0.f) / dof;
  mean = sc[e] + m1;
  std = sqrtf(var);
}

// Shared memory of a kernel with two (128, kStride) activation buffers, the
// two weight chunk buffers and the shifted sums.
inline size_t smem_bytes(int out_dim) {
  return sizeof(float) * (2 * kWidth * kStride + 2 * kChunk * kWidth +
                          3 * kTileRows * out_dim);
}

// ---------------------------------------------------------------------------
// The ensemble pass: the FFMA probes (ablate_chain.cu) instantiate it with
// flags that set the layouts of x and of the outputs.

// kOutRows: (B, ow), zeros past out_dim; kOutCols: feature-major (ow, B);
// kOutPacked: one (B, 128) buffer, mean in columns [0, out_dim), std in
// [out_dim, 2 out_dim).
enum OutLayout { kOutRows = 1, kOutCols = 2, kOutPacked = 3 };

// Store the tile's outputs in one of the probe's layouts: val(col, r, a, b)
// gives out0's and out1's element at (row r of the tile, column col). The
// (B, ow) layouts go through t0/t1 (two free (64, 129) buffers) so that the
// device stores are row-contiguous.
template <int kOut, int kNOut, class V>
__device__ __forceinline__ void store_tile(const V& val, int valid,
                                           long long row0, long long B, int ow,
                                           int out_dim, float* out0,
                                           float* out1, float* t0, float* t1) {
  if constexpr (kOut == kOutCols) {
    for (int e = threadIdx.x; e < kTileRows * ow; e += kThreads) {
      const int col = e / kTileRows, r = e % kTileRows;
      if (r >= valid) continue;
      float a, b;
      val(col, r, a, b);
      out0[col * B + row0 + r] = a;
      if (kNOut > 1) out1[col * B + row0 + r] = b;
    }
  } else {
    constexpr int kT = kWidth + 1;
    __syncthreads();   // every thread's last-layer reads and sums are done
    for (int e = threadIdx.x; e < kTileRows * ow; e += kThreads) {
      const int col = e / kTileRows, r = e % kTileRows;
      if (r >= valid) continue;
      float a = 0.f, b = 0.f, unused;
      if (kOut == kOutPacked) {
        if (col < out_dim)
          val(col, r, a, unused);
        else if (col < 2 * out_dim)
          val(col - out_dim, r, unused, a);
      } else {
        val(col, r, a, b);
      }
      t0[r * kT + col] = a;
      if (kNOut > 1) t1[r * kT + col] = b;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < valid * ow; e += kThreads) {
      const int r = e / ow, col = e % ow;
      const size_t o = static_cast<size_t>(row0 + r) * ow + col;
      out0[o] = t0[r * kT + col];
      if (kNOut > 1) out1[o] = t1[r * kT + col];
    }
  }
}

// One block's pass over a 64-row tile: members [0, M) of the (M_all-member)
// folded chain, layers [0, L). x holds d real features, element (row,
// feature) at x[row * ldx + feature] (row-major) or, with kXCols,
// x[feature * ldx + row]; out_dim is layer L-1's width (<= 128). out0 and
// out1 receive the shifted mean and std (out1 unused when kNOut is 1) in
// the layout kOut; ow: the output width (rows for kOutCols).
template <int kNOut, bool kXCols, int kOut>
__device__ __forceinline__ void ensemble_pass(
    float* smem, const float* __restrict__ x, long long B, int d,
    long long ldx, const float* __restrict__ w_all,
    const float* __restrict__ b_all, int M_all, int M, int L,
    const int* __restrict__ relu, int out_dim, int ow,
    float* __restrict__ out0, float* __restrict__ out1) {
  float* act0 = smem;
  float* act1 = act0 + kWidth * kStride;
  float* sw = act1 + kWidth * kStride;
  float* sc = sw + 2 * kChunk * kWidth;
  float* s1 = sc + kTileRows * out_dim;
  float* s2 = s1 + kTileRows * out_dim;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kTileRows), B - row0));
  const XStrided at = kXCols ? XStrided{1, ldx} : XStrided{ldx, 1};
  const float* x_tile = kXCols ? x + row0 : x + row0 * ldx;
  const float* w_hidden = w_all + static_cast<size_t>(M_all) * d * kWidth;

  for (int m = 0; m < M; ++m) {
    __syncthreads();  // the previous member's last layer may still read act0
    float* in = act0;
    float* out = act1;
    for (int l = 0; l + 1 < L; ++l) {
      const float* b = b_all + (static_cast<size_t>(l) * M_all + m) * kWidth;
      const bool act = __ldg(relu + l) != 0;
      if (l == 0) {
        dense_layer<true>(
            in, out, sw, w_all + static_cast<size_t>(m) * d * kWidth, b, d,
            act, x_tile, valid, at);
      } else {
        dense_layer<false>(
            in, out, sw,
            w_hidden + (static_cast<size_t>(l - 1) * M_all + m) * kWidth * kWidth,
            b, kWidth, act, nullptr, valid);
      }
      float* t = in;
      in = out;
      out = t;
    }
    __syncthreads();  // the last epilogue's stores must land before the reads
    const int l = L - 1;
    const float* b = b_all + (static_cast<size_t>(l) * M_all + m) * kWidth;
    const bool act = __ldg(relu + l) != 0;
    if (l == 0) {  // one Linear: read x straight from device memory
      last_layer_stats(
          x_tile, kXCols ? ldx : 1, kXCols ? 1 : ldx, valid,
          w_all + static_cast<size_t>(m) * d * kWidth, b, d, act, out_dim,
          m == 0, sc, s1, s2);
    } else {
      last_layer_stats(
          in, kStride, 1, valid,
          w_hidden + (static_cast<size_t>(l - 1) * M_all + m) * kWidth * kWidth,
          b, kWidth, act, out_dim, m == 0, sc, s1, s2);
    }
  }
  const float n = static_cast<float>(M);
  const float dof = static_cast<float>(M > 1 ? M - 1 : 1);
  store_tile<kOut, kNOut>(
      [&](int col, int r, float& a, float& b) {
        const int e = col * kTileRows + r;
        if (col >= out_dim)
          a = b = 0.f;
        else
          shifted_stat(sc, s1, s2, e, n, dof, a, b);
      },
      valid, row0, B, ow, out_dim, out0, out1, act0, act1);
}

}  // namespace fused_chain
