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
// at the dense bf16 tensor-core peak (989 TFLOP/s on an H100 SXM); its
// tile is fused_chain_bf16.cuh's, with u in a (64, 136) fp32 buffer.
#include "fused_chain.cuh"
#include "fused_chain_bf16.cuh"

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

// The bf16 form: w_all as above in bf16, b_all and v fp32.
__global__ void __launch_bounds__(kThreads, 2)
    fused_anchored_bf16_kernel(const float* __restrict__ x, long long B, int d,
                               const __nv_bfloat16* __restrict__ w_all,
                               const float* __restrict__ b_all, int L,
                               const int* __restrict__ relu,
                               const float* __restrict__ v, int k,
                               int out_dim, float* __restrict__ mean,
                               float* __restrict__ std) {
  namespace fb = fused_chain_bf16;
  using bf16 = fb::bf16;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* act = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sw = act + kTileRows * fb::kAStride;
  float* ubuf = reinterpret_cast<float*>(sw + 2 * kChunk * fb::kWStride);
  float* sc = ubuf + kTileRows * fb::kUStride;
  float* s1 = sc + kTileRows * out_dim;
  float* s2 = s1 + kTileRows * out_dim;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kTileRows), B - row0));
  const float* x_tile = x + row0 * d;
  const bf16* w_hidden = w_all + static_cast<size_t>(d) * kWidth;
  const bool relu0 = __ldg(relu) != 0;
  const Identity none;

  // u = bf16(x) @ W_bot + b0 in fp32, without the ReLU; x is staged in act
  fb::dense_layer<true, true>(act, ubuf, sw, w_all, b_all, d, false, x_tile,
                              d, valid, none, none);
  for (int j = 0; j < k; ++j) {
    __syncthreads();  // u's stores, or the last anchor's reads of act
    const float* vj = v + static_cast<size_t>(j) * kWidth;
    for (int e = threadIdx.x; e < kWidth * kTileRows; e += kThreads) {
      const int r = e / kWidth, n = e % kWidth;
      const float h = ubuf[r * fb::kUStride + n] + __ldg(vj + n);
      act[r * fb::kAStride + n] = __float2bfloat16_rn(relu0 ? fmaxf(h, 0.f) : h);
    }
    for (int l = 1; l + 1 < L; ++l) {
      fb::dense_layer<false>(
          act, act, sw, w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth,
          b_all + static_cast<size_t>(l) * kWidth, kWidth,
          __ldg(relu + l) != 0, nullptr, 0, valid, none, none);
    }
    __syncthreads();  // the last epilogue's stores must land before the reads
    const int l = L - 1;
    fb::last_layer_stats(
        fb::ActLoad{act}, valid,
        w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth,
        b_all + static_cast<size_t>(l) * kWidth, kWidth, __ldg(relu + l) != 0,
        out_dim, j == 0, sc, s1, s2);
  }
  __syncthreads();  // the slots' owners are not write_stats' threads
  write_stats(sc, s1, s2, k, valid, row0, out_dim, mean, std);
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

// The bf16 form; as nnueehcs_fused_anchored_f32 with w_all in bf16.
int nnueehcs_fused_anchored_bf16(const float* x, long long B, int d,
                                 const __nv_bfloat16* w_all,
                                 const float* b_all, int L, const int* relu,
                                 const float* v, int k, int out_dim,
                                 float* mean, float* std, void* stream) {
  const size_t smem = fused_chain_bf16::smem_bytes(out_dim, true);
  cudaError_t err = cudaFuncSetAttribute(
      fused_anchored_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  fused_anchored_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      x, B, d, w_all, b_all, L, relu, v, k, out_dim, mean, std);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
