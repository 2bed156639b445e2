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
//
// The bf16 form (fused_ensemble_bf16_kernel, kernel 1b) replaces the same
// TPU kernel run with compute_dtype=bfloat16: weights folded in fp32 and
// rounded to bf16, x and every hidden activation rounded to bf16 at the next
// dot, products accumulated in fp32, bias, ReLU, the last layer and the
// shifted sums in fp32. What bounds it: operations, at the dense bf16
// tensor-core peak (989 TFLOP/s on an H100 SXM, 0.35 ms at the flagship).
// Its design is fused_chain_wgmma.cuh's ensemble_pass: one thread-block
// cluster of c = min(M, 8) blocks, block r holding members r, r + c, ... of
// the chain resident in shared memory (169,984 bytes a member at the
// flagship; streamed through a ring when they do not fit), consumer
// warpgroups of wgmma products with the activations in registers, each
// owning a 64-row tile that every block of the cluster runs for its own
// members; the members' outputs meet in the leader block through
// distributed shared memory, where they are summed in member order. A
// persistent grid of as many clusters as the card runs at once. Weights
// are read from device memory once per block, not once per tile.
#include "fused_chain.cuh"
#include "fused_chain_wgmma.cuh"

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

namespace fw = fused_chain_wgmma;

// The bf16 form. images: each member's chain image (ops/fused_eval_chain.py
// chain_image), member-major; b_all (L, M, 128) fp32; lay: the launch
// layout (eval_layout('ensemble', ...)).
template <bool kRing>
__global__ void __launch_bounds__(kRing ? fw::kWgThreads + 32 : 3 * fw::kWgThreads, 1)
    fused_ensemble_bf16_kernel(const float* __restrict__ x, long long B, int d,
                               const unsigned char* __restrict__ images,
                               const float* __restrict__ b_all, int M, int L,
                               const int* __restrict__ relu, int out_dim,
                               float* __restrict__ mean,
                               float* __restrict__ std,
                               fw::EnsembleLayout lay) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  fw::ensemble_pass<kRing, false>(smem_wg, x, B, d, d, images, b_all, M, L,
                                  relu, out_dim, mean, std, lay);
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

// The bf16 form: as nnueehcs_fused_ensemble_f32 with the members' chain
// images (ops/fused_eval_chain.py chain_image, member-major) in place of
// w_all, and the launch layout (eval_layout('ensemble', ...),
// ENSEMBLE_FIELDS) as host ints.
int nnueehcs_fused_ensemble_bf16(const float* x, long long B, int d,
                                 const unsigned char* images,
                                 const float* b_all, int M, int L,
                                 const int* relu, int out_dim, float* mean,
                                 float* std, const int* layout, void* stream) {
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  const auto kernel = lay.base.ring ? fused_ensemble_bf16_kernel<true>
                                    : fused_ensemble_bf16_kernel<false>;
  return static_cast<int>(fw::launch_cluster(
      kernel, lay, static_cast<cudaStream_t>(stream), x, B, d, images, b_all,
      M, L, relu, out_dim, mean, std, lay));
}

// The thread-block clusters of the bf16 form's layout `layout` that the card
// runs at once, or minus a cudaError_t.
int nnueehcs_fused_ensemble_bf16_clusters(const int* layout) {
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  return lay.base.ring ? fw::max_clusters(fused_ensemble_bf16_kernel<true>, lay)
                       : fw::max_clusters(fused_ensemble_bf16_kernel<false>,
                                          lay);
}

}  // extern "C"

STAMPS_READER(fused_ensemble)
