// Fused deep-ensemble UE pass for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/fused_ensemble.py::_fused_kernel (the Pallas TPU
// kernel). Same function: for each tile of rows, every member's
// BatchNorm-folded Linear(+ReLU) chain; member 0's output is the shift c;
// s1 = sum (h - c) and s2 = sum (h - c)^2 over members 1..M-1; then
// mean = c + s1/M and std = sqrt(max(s2 - M*m1^2, 0)/(M-1)) with m1 = s1/M.
// Only the (B, out_dim) mean and std are written to device memory.
//
// What bounds it on an H100: operations. The flagship ensemble (8 members,
// 5 inputs, 7 Linear layers 128 wide) does 82,688 multiply-adds per row per
// member against 20 bytes of input and 8 bytes of output per row, thousands
// of FLOP per byte, far past the ~20 FLOP/byte where fp32 work stops being
// memory bound. The products run in true fp32 on the CUDA cores (no TF32), so
// the floor is the fp32 FFMA peak (67 TFLOP/s on an H100 SXM at 700 W).
//
// What the design does about it:
// - nothing but x, the folded weights and the two outputs touches device
//   memory: one block of 256 threads owns a 64-row tile and loops over the
//   members itself; activations stay in shared memory, kept feature-major
//   and ping-ponged between two buffers from layer to layer;
// - x is staged into shared memory 32 feature columns at a time, beside the
//   matching chunk of layer 0's weights, so the input may be any width (the
//   TPU kernel pads it; only the layer widths must fit 128);
// - each thread owns a 4-row x 8-column register tile, so one k step costs
//   three 16-byte shared loads for 32 FMAs, and a warp's loads fall on
//   distinct banks;
// - each member/layer's weights stream through shared memory in 32-row
//   chunks, double-buffered with cp.async so the next chunk is in flight
//   while this one is used; ~104 KB of shared memory per block leaves room
//   for two blocks on an SM;
// - the last layer (1 real column on the flagship) is computed as dot
//   products over its real columns only, and feeds the shifted sums c, s1,
//   s2 directly; each (row, column) slot of those sums is owned by one
//   thread for every member, so they need no synchronisation.
// Tensor cores (wgmma with a 3xTF32 split to keep fp32 accuracy) are left to
// a later version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// out[n][r] = act(sum_k in[k][r] * w[k][n] + b[n]) for the tile's 64 rows
// and all 128 (padded) columns n. in/out are feature-major (row stride
// kStride); w is the member/layer's (K, 128) folded weight in device memory.
// With kFromX (layer 0), the input is the tile's rows of x, (valid, K)
// row-major in device memory: each chunk of K is staged into one of two
// kChunk-row slots of `in` (rows past `valid` as zeros) beside its weights.
template <bool kFromX>
__device__ __forceinline__ void dense_layer(float* in, float* out, float* sw,
                                            const float* w, const float* b,
                                            int K, bool relu, const float* x,
                                            int valid) {
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
          r < valid ? __ldg(x + static_cast<size_t>(r) * K + k0 + k) : 0.f;
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
    float4 v = make_float4(acc[0][j] + bj, acc[1][j] + bj, acc[2][j] + bj,
                           acc[3][j] + bj);
    if (relu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    *reinterpret_cast<float4*>(out + col * kStride + ty * 4) = v;
  }
}

// Last layer of member `member`, real columns only, folded straight into the
// shifted sums. Slot e = col * kTileRows + row belongs to the same thread for
// every member. Input element (k, r) is in[k * k_step + r * r_step]: the
// feature-major activations, or x itself when the network is one Linear.
// Rows past `valid` are never written out, so they are skipped.
__device__ __forceinline__ void last_layer_stats(const float* in, int k_step,
                                                 int r_step, int valid,
                                                 const float* w,
                                                 const float* b, int K,
                                                 bool relu, int out_dim,
                                                 int member, float* sc,
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
    if (member == 0) {
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

size_t smem_bytes(int out_dim) {
  return sizeof(float) * (2 * kWidth * kStride + 2 * kChunk * kWidth +
                          3 * kTileRows * out_dim);
}

// w_all: layer 0 as (M, d, 128), then layers 1..L-1 as (M, 128, 128);
// b_all: (L, M, 128). relu[l] != 0: ReLU after layer l.
__global__ void __launch_bounds__(kThreads, 2)
    fused_ensemble_kernel(const float* __restrict__ x, long long B, int d,
                          const float* __restrict__ w_all,
                          const float* __restrict__ b_all, int M, int L,
                          const int* __restrict__ relu, int out_dim,
                          float* __restrict__ mean, float* __restrict__ std) {
  extern __shared__ __align__(16) float smem[];
  float* act0 = smem;
  float* act1 = act0 + kWidth * kStride;
  float* sw = act1 + kWidth * kStride;
  float* sc = sw + 2 * kChunk * kWidth;
  float* s1 = sc + kTileRows * out_dim;
  float* s2 = s1 + kTileRows * out_dim;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kTileRows), B - row0));
  const float* x_tile = x + row0 * d;
  const float* w_hidden = w_all + static_cast<size_t>(M) * d * kWidth;

  for (int m = 0; m < M; ++m) {
    __syncthreads();  // the previous member's last layer may still read act0
    float* in = act0;
    float* out = act1;
    for (int l = 0; l + 1 < L; ++l) {
      const float* b = b_all + (static_cast<size_t>(l) * M + m) * kWidth;
      const bool act = __ldg(relu + l) != 0;
      if (l == 0) {
        dense_layer<true>(in, out, sw, w_all + static_cast<size_t>(m) * d * kWidth,
                          b, d, act, x_tile, valid);
      } else {
        dense_layer<false>(in, out, sw,
                           w_hidden + (static_cast<size_t>(l - 1) * M + m) *
                                          kWidth * kWidth,
                           b, kWidth, act, nullptr, valid);
      }
      float* t = in;
      in = out;
      out = t;
    }
    __syncthreads();  // the last epilogue's stores must land before the reads
    const int l = L - 1;
    const float* b = b_all + (static_cast<size_t>(l) * M + m) * kWidth;
    const bool act = __ldg(relu + l) != 0;
    if (l == 0) {  // one Linear: read x straight from device memory
      last_layer_stats(x_tile, 1, d, valid,
                       w_all + static_cast<size_t>(m) * d * kWidth, b, d, act,
                       out_dim, m, sc, s1, s2);
    } else {
      last_layer_stats(in, kStride, 1, valid,
                       w_hidden + (static_cast<size_t>(l - 1) * M + m) *
                                      kWidth * kWidth,
                       b, kWidth, act, out_dim, m, sc, s1, s2);
    }
  }

  const float n = static_cast<float>(M);
  const float dof = static_cast<float>(M > 1 ? M - 1 : 1);
  for (int e = threadIdx.x; e < kTileRows * out_dim; e += kThreads) {
    const int col = e / kTileRows, r = e % kTileRows;
    if (r < valid) {
      const float m1 = s1[e] / n;
      const float var = fmaxf(s2[e] - n * m1 * m1, 0.f) / dof;
      const size_t o = static_cast<size_t>(row0 + r) * out_dim + col;
      mean[o] = sc[e] + m1;
      std[o] = sqrtf(var);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks d >= 1, 1 <= out_dim <= 128, every hidden width <= 128 (zero-padded
// to 128 in w_all/b_all), L >= 1, M >= 1, B >= 1, fp32 contiguous device
// buffers, relu as L int32 flags on the device, and allocates mean/std as
// (B, out_dim).
int nnueehcs_fused_ensemble_f32(const float* x, long long B, int d,
                                const float* w_all, const float* b_all, int M,
                                int L, const int* relu, int out_dim,
                                float* mean, float* std, void* stream) {
  const size_t smem = smem_bytes(out_dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ensemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  fused_ensemble_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, B, d, w_all, b_all, M, L, relu, out_dim, mean, std);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
