// Fused anchored (Delta-UQ / PAGER) UE pass for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/fused_anchored.py::_anchored_kernel (the Pallas
// TPU kernel). Same function: the anchored input concat([a, x - a]) meets
// the first Linear as x @ W_bot + a @ (W_top - W_bot), so per tile of rows
// u = x @ W_bot + b0 is computed once; for anchor j, h = relu0(u + v_j) with
// v_j = a_j @ (W_top - W_bot) (computed by the caller, one (k, 128) array),
// then the rest of the BatchNorm-folded Linear(+ReLU) chain. Anchor 0's
// output is the shift c; s1 = sum (h - c) and s2 = sum (h - c)^2 over the k
// anchors give mean = c + s1/k and std = sqrt(max(s2 - k*m1^2, 0)/(k-1)).
// Only the (B, out_dim) mean and std are written to device memory; no
// (k, B, 2d) anchored input exists anywhere.
//
// What bounds it on an H100: operations. The flagship Delta-UQ net (5
// inputs doubled to 10, 7 Linear layers 128 wide, 229 anchors) does 1,280
// multiply-adds per row once plus 82,048 per row per anchor, against 28
// bytes moved per row; the fp32 FFMA peak (67 TFLOP/s at 700 W) is the floor.
//
// What the design does about it: the tile machinery of the ensemble kernel
// (fused_chain.cuh) with the anchor loop in place of the member loop. u
// stays in shared memory for the whole anchor loop; adding v_j and the ReLU
// is one pass over the tile; the hidden layers then run in place in a
// single activation buffer (a layer reads all of its input before its
// epilogue writes), so u costs no more shared memory than the ensemble
// kernel's second buffer and two blocks still fit on an SM.
//
// The bf16 form (fused_anchored_bf16_kernel) replaces the same TPU kernel
// run with compute_dtype=bfloat16: u = bf16(x) @ bf16(W_bot) + b0 is kept
// in fp32; v_j = a_j @ (W_top - W_bot) stays fp32 (unrounded anchors, the
// fp32 W_top - W_bot); h = u + v_j is fp32 and is rounded to bf16 only at
// the next dot, as every later activation is. What bounds it: operations,
// at the dense bf16 tensor-core peak (989 TFLOP/s on an H100 SXM). Its
// design is fused_chain_wgmma.cuh's: persistent blocks holding the chain
// in shared memory, two warpgroups of wgmma products a block with the
// activations in registers; u stays in the warpgroup's registers for the
// whole anchor loop, and each anchor's layer 0 is relu(u + v_j) in fp32,
// rounded into the A operand, with v_j read through L1.
#include "fused_chain.cuh"
#include "fused_chain_wgmma.cuh"

using namespace fused_chain;

namespace {

// w_all: W_bot as (d, 128), then layers 1..L-1 as (128, 128); b_all: (L, 128)
// with b0 first. relu[l] != 0: ReLU after layer l (after adding v_j for
// layer 0). v: (k, 128), zero past layer 0's width.
__global__ void __launch_bounds__(kThreads, 2)
    fused_anchored_kernel(const float* __restrict__ x, long long B, int d,
                          const float* __restrict__ w_all,
                          const float* __restrict__ b_all, int L,
                          const int* __restrict__ relu,
                          const float* __restrict__ v, int k, int out_dim,
                          float* __restrict__ mean, float* __restrict__ std) {
  extern __shared__ __align__(16) float smem[];
  float* ubuf = smem;
  float* act = ubuf + kWidth * kStride;
  float* sw = act + kWidth * kStride;
  float* sc = sw + 2 * kChunk * kWidth;
  float* s1 = sc + kTileRows * out_dim;
  float* s2 = s1 + kTileRows * out_dim;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kTileRows), B - row0));
  const float* x_tile = x + row0 * d;
  const float* w_hidden = w_all + static_cast<size_t>(d) * kWidth;
  const bool relu0 = __ldg(relu) != 0;
  const Identity none;

  // u = x @ W_bot + b0, without the ReLU; x is staged in act
  dense_layer<true>(act, ubuf, sw, w_all, b_all, d, false, x_tile, valid,
                    none, none);
  for (int j = 0; j < k; ++j) {
    __syncthreads();  // u's stores, or the last anchor's reads of act
    const float* vj = v + static_cast<size_t>(j) * kWidth;
    for (int e = threadIdx.x; e < kWidth * kTileRows; e += kThreads) {
      const int n = e / kTileRows, r = e % kTileRows;
      const float h = ubuf[n * kStride + r] + __ldg(vj + n);
      act[n * kStride + r] = relu0 ? fmaxf(h, 0.f) : h;
    }
    for (int l = 1; l + 1 < L; ++l) {
      dense_layer<false>(act, act, sw,
                         w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth,
                         b_all + static_cast<size_t>(l) * kWidth, kWidth,
                         __ldg(relu + l) != 0, nullptr, valid, none, none);
    }
    __syncthreads();  // the last epilogue's stores must land before the reads
    const int l = L - 1;
    last_layer_stats(act, kStride, 1, valid,
                     w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth,
                     b_all + static_cast<size_t>(l) * kWidth, kWidth,
                     __ldg(relu + l) != 0, out_dim, j == 0, sc, s1, s2, none);
  }
  write_stats(sc, s1, s2, k, valid, row0, out_dim, mean, std);
}

namespace fw = fused_chain_wgmma;

// The bf16 form. image: the chain packed by ops/fused_eval_chain.py
// (chain_image, W_bot as layer 0); b_all (L, 128), v (k, 128) fp32; lay:
// the launch layout (eval_layout).
template <bool kRing>
__global__ void __launch_bounds__(kRing ? fw::kWgThreads + 32 : 2 * fw::kWgThreads, 1)
    fused_anchored_bf16_kernel(const float* __restrict__ x, long long B, int d,
                               const unsigned char* __restrict__ image,
                               const float* __restrict__ b_all, int L,
                               const int* __restrict__ relu,
                               const float* __restrict__ v, int k,
                               int out_dim, float* __restrict__ mean,
                               float* __restrict__ std, fw::Layout lay) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const fw::Chain chain(d, L, lay.out_groups);
  fw::Weights<kRing> wts(smem_wg, lay);
  const int wg = threadIdx.x / fw::kWgThreads;
  if (threadIdx.x == 0) wts.init(lay.warpgroups);
  __syncthreads();
  const fw::Tiles tiles(B, lay, wg);
  if (kRing && wg == lay.warpgroups) {  // the ring's producer warp
    if (threadIdx.x % 32 == 0)
      for (int r = 0; r < tiles.rounds; ++r) {
        for (int b = 0; b < chain.nb0; ++b) wts.produce(chain, image, b);
        for (int j = 0; j < k; ++j)
          for (int b = chain.nb0; b < chain.blocks(); ++b)
            wts.produce(chain, image, b);
      }
    return;
  }
  STAMP_BEGIN(true, 0);
  if (!kRing) {
    if (threadIdx.x == 0) wts.load_image(image, lay.image_bytes);
    STAMP(1);
    fw::mbar_wait(wts.full, 0);
  }
  const fw::Thread t(threadIdx.x);
  float4* st = reinterpret_cast<float4*>(smem_wg + lay.smem_stats) +
               (wg * lay.out_groups * 3) * fw::kWgThreads + t.lt;
  const int groups = lay.out_groups;
  const int last = L - 1;
  const float* b_last = b_all + static_cast<size_t>(last) * fw::kWidth;
  const bool relu0 = __ldg(relu) != 0;
  const bool relu_last = __ldg(relu + last) != 0;
  const uint32_t none[2] = {0u, 0u};
  float acc[64], u[64], acc_last[4];   // written by each first product
  uint32_t a[8][4];
  for (int r = 0;; ++r) {
    const int tile = tiles.tile<kRing>(r);
    if (tile < 0) break;
    const long long row0 = static_cast<long long>(tile) * fw::kRows;
    const int valid = tiles.valid(tile, B);
    const float* x_tile = x + (valid > 0 ? row0 * d : 0);
    // u = bf16(x) @ W_bot + b0, fp32, kept for every anchor
    fw::layer0_from_x(acc, wts, chain, x_tile, d, d, valid, t, fw::NoMask(),
                      [] {});
    STAMP(7);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 b0 =
          __ldg(reinterpret_cast<const float2*>(b_all + 8 * i + 2 * t.q));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        u[4 * i + e] = acc[4 * i + e] + ((e & 1) ? b0.y : b0.x);
    }
    for (int j = 0; j < k; ++j) {
      // layer 0 of anchor j: relu(u + v_j), rounded into A
      STAMP(7);
      const float* vj = v + static_cast<size_t>(j) * fw::kWidth;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 vv =
            __ldg(reinterpret_cast<const float2*>(vj + 8 * i + 2 * t.q));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float h0 = u[4 * i + 2 * h] + vv.x, h1 = u[4 * i + 2 * h + 1] + vv.y;
          if (relu0) {
            h0 = fmaxf(h0, 0.f);
            h1 = fmaxf(h1, 0.f);
          }
          a[i >> 1][2 * (i & 1) + h] = fw::pack(h0, h1);
        }
      }
      for (int l = 1; l < last; ++l) {
        const uint32_t addr = wts.acquire(chain, chain.nb0 + l - 1);
        fw::issue_n128(acc, a, addr);
        fw::wait_acc(acc, a);
        wts.release(t.lane0);
        fw::epilogue<false>(acc, b_all + static_cast<size_t>(l) * fw::kWidth,
                            __ldg(relu + l) != 0, none, 1.f, t, a);
      }
      const uint32_t addr = wts.acquire(chain, chain.nb0 + last - 1);
      for (int g = 0; g < groups; ++g) {
        fw::last_group(acc_last, a, addr, g);
        fw::stats_update(acc_last, b_last, relu_last, g, t, j == 0, st);
      }
      wts.release(t.lane0);
    }
    fw::stats_write(st, groups, k, t, valid, row0, out_dim, out_dim, mean,
                    std);
  }
  STAMP_END();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks d >= 1, L >= 2, 1 <= out_dim <= 128, every other width <= 128
// (zero-padded to 128 in w_all/b_all/v), k >= 1, B >= 1, fp32 contiguous
// device buffers, relu as L int32 flags on the device, and allocates
// mean/std as (B, out_dim).
int nnueehcs_fused_anchored_f32(const float* x, long long B, int d,
                                const float* w_all, const float* b_all, int L,
                                const int* relu, const float* v, int k,
                                int out_dim, float* mean, float* std,
                                void* stream) {
  const size_t smem = smem_bytes(out_dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_anchored_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  fused_anchored_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, B, d, w_all, b_all, L, relu, v, k, out_dim, mean, std);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: as nnueehcs_fused_anchored_f32 with the chain as its
// bf16 image (ops/fused_eval_chain.py chain_image) in place of w_all, and
// the launch layout (eval_layout, LAYOUT_FIELDS) as host ints.
int nnueehcs_fused_anchored_bf16(const float* x, long long B, int d,
                                 const unsigned char* image,
                                 const float* b_all, int L, const int* relu,
                                 const float* v, int k, int out_dim,
                                 float* mean, float* std, const int* layout,
                                 void* stream) {
  const fused_chain_wgmma::Layout lay = fused_chain_wgmma::Layout::from(layout);
  const auto kernel = lay.ring ? fused_anchored_bf16_kernel<true> : fused_anchored_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<lay.grid, lay.threads, lay.smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      x, B, d, image, b_all, L, relu, v, k, out_dim, mean, std, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

STAMPS_READER(fused_anchored)
