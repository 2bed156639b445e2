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
// What the design does about it (the tile machinery is in fused_chain.cuh):
// - nothing but x, the folded weights and the two outputs touches device
//   memory: one block of 256 threads owns a 64-row tile and loops over the
//   members itself; activations stay in shared memory, kept feature-major
//   and ping-ponged between two buffers from layer to layer;
// - x is staged into shared memory 32 feature columns at a time, so the
//   input may be any width (the TPU kernel pads it; only the layer widths
//   must fit 128);
// - each thread owns a 4-row x 8-column register tile; each member/layer's
//   weights stream through shared memory in 32-row chunks, double-buffered
//   with cp.async; ~104 KB of shared memory per block leaves room for two
//   blocks on an SM;
// - the last layer (1 real column on the flagship) is computed as dot
//   products over its real columns only, and feeds the shifted sums c, s1,
//   s2 directly, each slot owned by one thread for every member.
// Tensor cores (wgmma with a 3xTF32 split to keep fp32 accuracy) are left to
// a later version.
#include "fused_chain.cuh"

using namespace fused_chain;

namespace {

// w_all: layer 0 as (M, d, 128), then layers 1..L-1 as (M, 128, 128);
// b_all: (L, M, 128). relu[l] != 0: ReLU after layer l. The body is
// fused_chain.cuh's ensemble_pass with every attribution flag off.
__global__ void __launch_bounds__(kThreads, 2)
    fused_ensemble_kernel(const float* __restrict__ x, long long B, int d,
                          const float* __restrict__ w_all,
                          const float* __restrict__ b_all, int M, int L,
                          const int* __restrict__ relu, int out_dim,
                          float* __restrict__ mean, float* __restrict__ std) {
  extern __shared__ __align__(16) float smem[];
  ensemble_pass(smem, x, B, d, d, w_all, b_all, M, M, L, relu, out_dim,
                out_dim, 0, mean, std);
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
