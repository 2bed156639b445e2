// The bf16 forms of the fused ensemble kernel (kernel 1) and of its packed
// probe: fused_chain.cuh's tile machinery with bf16 GEMM operands on the
// tensor cores (the bf16 MC-dropout and anchored kernels are
// fused_chain_wgmma.cuh's). The function is the JAX package's
// compute_dtype=bfloat16: weights folded in fp32 and then rounded to bf16,
// every input of a dot rounded to bf16 (x as it is staged, each hidden
// activation after bias, ReLU and any dropout mask), products accumulated in
// fp32, biases, the last layer's output and the statistics in fp32.
//
// How the bf16 tile differs from the fp32 one (fused_chain.cuh):
// - Activations live in shared memory as bf16, row-major: element (row r,
//   feature k) at r * kAStride + k. The +8 pad puts the 8 rows an ldmatrix
//   reads on 8 distinct 16-byte bank groups.
// - Weights are stored and streamed as bf16, (K, 128) row-major, 32 rows a
//   chunk, double-buffered with cp.async as before (half the bytes); rows
//   past K up to the next multiple of 16 are zero-filled by cp.async, so the
//   zero-padded k of a short first layer meets zeros, never stale bits.
// - Each of the 8 warps owns a 16-row by 64-column slice of the 64 x 128
//   output tile and runs mma.sync.m16n8k16 (bf16 x bf16 -> fp32), operands
//   loaded with ldmatrix (.trans for the weights); its 8 accumulators of
//   4 fp32 are the slice.
// - The epilogue adds the fp32 bias and applies the ReLU on the fp32
//   accumulator, then rounds to bf16 into the other buffer.
// - x is staged 32 feature columns a chunk into a (64, 40) bf16 slot,
//   zero-padded to a multiple of 16 features.
// - The last layer keeps the scalar dot products over its real columns, on
//   bf16 operands with fp32 accumulation, four threads a (row, column) slot
//   whose partial sums meet by warp shuffles; the slot's first thread owns
//   it for every pass, as before.
// Only the conversion intrinsics of cuda_bf16.h are used.
#pragma once

#include <cuda_bf16.h>

#include "fused_chain.cuh"

namespace fused_chain_bf16 {

using fused_chain::kChunk;
using fused_chain::kThreads;
using fused_chain::kTileRows;
using fused_chain::kWidth;
using bf16 = __nv_bfloat16;

constexpr int kAStride = kWidth + 8;   // bf16 activation row (272 bytes)
constexpr int kWStride = kWidth + 8;   // bf16 weight chunk row
constexpr int kXStride = kChunk + 8;   // bf16 staged x row (80 bytes)
constexpr int kSlotThreads = 4;        // threads per last-layer slot

// Copy 16 bytes, or write 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// Start copying rows [k0, k0 + rows) of a (K, 128) bf16 weight matrix into
// dst (row stride kWStride), zero-filling rows up to the next multiple of 16.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* w, int k0,
                                           int rows) {
  constexpr int kSegs = kWidth / 8;    // 16-byte segments per row
  const int rows16 = (rows + 15) & ~15;
  for (int i = threadIdx.x; i < rows16 * kSegs; i += kThreads) {
    const int r = i / kSegs, q = i % kSegs;
    const bool valid = r < rows;
    cp_async16_zfill(dst + r * kWStride + q * 8,
                     valid ? w + static_cast<size_t>(k0 + r) * kWidth + q * 8
                           : w,
                     valid);
  }
}

// fused_chain::stream_weights for bf16 chunks.
template <class S, class F>
__device__ __forceinline__ void stream_weights(bf16* sw, const bf16* w, int K,
                                               S&& stage, F&& compute) {
  const int nchunks = (K + kChunk - 1) / kChunk;
  load_chunk(sw, w, 0, min(kChunk, K));
  fused_chain::cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      const int k1 = (c + 1) * kChunk;
      load_chunk(sw + ((c + 1) & 1) * kChunk * kWStride, w, k1,
                 min(kChunk, K - k1));
    }
    fused_chain::cp_async_commit();
    const int k0 = c * kChunk, rows = min(kChunk, K - k0);
    stage(c, k0, rows);
    fused_chain::cp_async_wait_all_but_one();
    __syncthreads();
    compute(sw + (c & 1) * kChunk * kWStride, c, k0, rows);
    __syncthreads();
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major): exact bf16
// products, fp32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// out = epi(r, n, act(bf16(in) @ bf16(w) + b)) for the tile's 64 rows and
// all 128 (padded) columns: rounded to bf16 into `out` (row stride
// kAStride).
// in/out may be the same buffer. w is a (K, 128) bf16 weight in device
// memory. With kFromX (layer 0) the input is the tile's rows of x (fp32,
// element (r, k) at x[r * ldx + k]): each 32-column chunk is staged, through
// xform and a rounding to bf16, into one of two (64, kXStride) slots of `in`
// (rows past `valid` and features past K as zeros) beside its weights.
template <bool kFromX, class XForm, class Epi>
__device__ __forceinline__ void dense_layer(bf16* in, void* out, bf16* sw,
                                            const bf16* w, const float* b,
                                            int K, bool relu, const float* x,
                                            long long ldx, int valid,
                                            const XForm& xform,
                                            const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (warp & 3) * 16;     // the warp's first row
  const int cb = (warp >> 2) * 64;    // and first column
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const auto stage = [&](int c, int k0, int rows) {
    if (!kFromX) return;
    bf16* dst = in + (c & 1) * kTileRows * kXStride;
    const int rows16 = (rows + 15) & ~15;
    for (int i = threadIdx.x; i < kTileRows * rows16; i += kThreads) {
      const int r = i / rows16, k = i - r * rows16;
      const float v =
          r < valid && k < rows
              ? xform(r, k0 + k, __ldg(x + r * ldx + k0 + k))
              : 0.f;
      dst[r * kXStride + k] = __float2bfloat16_rn(v);
    }
  };
  stream_weights(sw, w, K, stage, [&](const bf16* wc, int c, int k0,
                                      int rows) {
    const bf16* a = kFromX ? in + (c & 1) * kTileRows * kXStride : in + k0;
    const int lda = kFromX ? kXStride : kAStride;
    const int nk = (rows + 15) >> 4;
#pragma unroll 2
    for (int ks = 0; ks < nk; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (rb + (lane & 15)) * lda + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, wc + (ks * 16 + (lane & 15)) * kWStride + cb +
                                  np * 16 + (lane >> 4) * 8);
        mma(acc[2 * np], af, bq[0], bq[1]);
        mma(acc[2 * np + 1], af, bq[2], bq[3]);
      }
    }
  });

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = cb + nt * 8 + 2 * q;
    const float b0 = __ldg(b + col), b1 = __ldg(b + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rb + g + 8 * h;
      float v0 = acc[nt][2 * h] + b0, v1 = acc[nt][2 * h + 1] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      v0 = epi(r, col, v0);
      v1 = epi(r, col + 1, v1);
      __nv_bfloat162 p;
      p.x = __float2bfloat16_rn(v0);
      p.y = __float2bfloat16_rn(v1);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                         r * kAStride + col) = p;
    }
  }
}

// fused_chain::last_layer_stats on bf16 operands: slot e = col * kTileRows
// + row of the shifted sums gets h = act(sum_k load(r, k) * w[k][col] + b)
// with fp32 accumulation, w a (K, 128) bf16 weight in device memory and
// load(r, k) the (bf16-valued) input. Four threads share a slot, each
// summing a quarter of k; the quarter sums meet by shuffles and the first
// of the four owns the slot for every pass. That owner is not the thread
// fused_chain::write_stats gives the slot: synchronise before it.
template <class Load>
__device__ __forceinline__ void last_layer_stats(
    const Load& load, int valid, const bf16* w, const float* b, int K,
    bool relu, int out_dim, bool first, float* sc, float* s1, float* s2) {
  const int n = kTileRows * out_dim * kSlotThreads;
  const int lane = threadIdx.x & 31;
  const unsigned group = 0xFu << (lane & ~(kSlotThreads - 1));
  const int part = lane & (kSlotThreads - 1);
  const int span = (K + kSlotThreads - 1) / kSlotThreads;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int e = t / kSlotThreads;
    const int col = e / kTileRows, r = e % kTileRows;
    if (r >= valid) continue;   // the slot's four threads skip together
    const int k_end = min(K, (part + 1) * span);
    float acc = 0.f;
    for (int k = part * span; k < k_end; ++k)
      acc = fmaf(load(r, k),
                 __bfloat162float(w[static_cast<size_t>(k) * kWidth + col]),
                 acc);
    acc += __shfl_xor_sync(group, acc, 1);
    acc += __shfl_xor_sync(group, acc, 2);
    if (part != 0) continue;
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

// Loads of the last layer's input: the activations in shared memory, or,
// when the network is one Linear, x itself through xform, rounded to bf16.
struct ActLoad {
  const bf16* in;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return __bfloat162float(in[r * kAStride + k]);
  }
};

template <class XForm>
struct XLoad {
  const float* x;
  long long ldx;
  XForm xform;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return round_bf16(xform(r, k, __ldg(x + r * ldx + k)));
  }
};

// Shared memory of a kernel with two bf16 activation buffers, the two bf16
// weight chunk buffers and the shifted sums.
inline size_t smem_bytes(int out_dim) {
  return sizeof(bf16) * (2 * kTileRows * kAStride + 2 * kChunk * kWStride) +
         sizeof(float) * 3 * kTileRows * out_dim;
}

// Kernel 1's body in bf16: one block's pass over a 64-row tile, members
// [0, M) of the folded chain (w_all: layer 0 as (M, d, 128), then layers
// 1..L-1 as (M, 128, 128), bf16; b_all: (L, M, 128) fp32) on x's d real
// features, element (row, feature) at x[row * ldx + feature]. kOutDense:
// (B, out_dim) mean and std, kernel 1's; kOutPacked: one (B, 128) buffer,
// mean in columns [0, out_dim), std in [out_dim, 2 out_dim), zeros past
// (the packed probe's).
template <int kOut = fused_chain::kOutDense>
__device__ __forceinline__ void ensemble_pass(
    unsigned char* smem, const float* __restrict__ x, long long B, int d,
    long long ldx, const bf16* __restrict__ w_all, const float* __restrict__ b_all, int M,
    int L, const int* __restrict__ relu, int out_dim,
    float* __restrict__ out0, float* __restrict__ out1) {
  bf16* act0 = reinterpret_cast<bf16*>(smem);
  bf16* act1 = act0 + kTileRows * kAStride;
  bf16* sw = act1 + kTileRows * kAStride;
  float* sc = reinterpret_cast<float*>(sw + 2 * kChunk * kWStride);
  float* s1 = sc + kTileRows * out_dim;
  float* s2 = s1 + kTileRows * out_dim;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int valid =
      static_cast<int>(min(static_cast<long long>(kTileRows), B - row0));
  const float* x_tile = x + row0 * ldx;
  const bf16* w_hidden = w_all + static_cast<size_t>(M) * d * kWidth;
  const fused_chain::Identity none;

  for (int m = 0; m < M; ++m) {
    __syncthreads();  // the previous member's last layer may still read act0
    bf16* in = act0;
    bf16* out = act1;
    for (int l = 0; l + 1 < L; ++l) {
      const float* b = b_all + (static_cast<size_t>(l) * M + m) * kWidth;
      const bool act = __ldg(relu + l) != 0;
      if (l == 0) {
        dense_layer<true>(in, out, sw,
                          w_all + static_cast<size_t>(m) * d * kWidth, b, d,
                          act, x_tile, ldx, valid, none, none);
      } else {
        dense_layer<false>(
            in, out, sw,
            w_hidden + (static_cast<size_t>(l - 1) * M + m) * kWidth * kWidth,
            b, kWidth, act, nullptr, 0, valid, none, none);
      }
      bf16* t = in;
      in = out;
      out = t;
    }
    __syncthreads();  // the last epilogue's stores must land before the reads
    const int l = L - 1;
    const float* b = b_all + (static_cast<size_t>(l) * M + m) * kWidth;
    const bool act = __ldg(relu + l) != 0;
    if (l == 0) {
      last_layer_stats(XLoad<fused_chain::Identity>{x_tile, ldx, none}, valid,
                       w_all + static_cast<size_t>(m) * d * kWidth, b, d, act,
                       out_dim, m == 0, sc, s1, s2);
    } else {
      last_layer_stats(
          ActLoad{in}, valid,
          w_hidden + (static_cast<size_t>(l - 1) * M + m) * kWidth * kWidth,
          b, kWidth, act, out_dim, m == 0, sc, s1, s2);
    }
  }
  if constexpr (kOut == fused_chain::kOutDense) {
    __syncthreads();  // a slot's owner in last_layer_stats is not write_stats'
    fused_chain::write_stats(sc, s1, s2, M, valid, row0, out_dim, out0, out1);
  } else {
    const float n = static_cast<float>(M);
    const float dof = static_cast<float>(M > 1 ? M - 1 : 1);
    // the (64, 129) fp32 transpose buffer spans act0 and act1
    fused_chain::store_tile<kOut, 1>(
        [&](int col, int r, float& a, float& b) {
          if (col >= out_dim) {
            a = b = 0.f;
          } else {
            fused_chain::shifted_stat(sc, s1, s2, col * kTileRows + r, n,
                                      dof, a, b);
          }
        },
        valid, row0, B, kWidth, out_dim, out0, nullptr,
        reinterpret_cast<float*>(act0), nullptr);
  }
}

}  // namespace fused_chain_bf16
