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
// of FLOP per byte. Its products run as 3xTF32 on the tensor cores
// (fused_chain_wgmma.cuh, its fp32 section): three TF32 products per fp32
// one at the dense TF32 peak (495 TFLOP/s on an H100 SXM), 2.10 ms at the
// flagship on 262,144 rows; the fp32 FFMA floor (67 TFLOP/s) was 5.18 ms.
//
// What the design does about it (fused_ensemble_kernel, the body
// fused_chain_wgmma.cuh's ensemble_tf32): one thread-block cluster of c =
// min(M, 8) blocks runs the tiles of its unit, block r members r, r + c,
// ... of each tile, so a small request still spreads over the card: a
// 128-row request runs its two tiles on two clusters of 8 blocks (one
// consumer warpgroup a block when the tiles do not fill the clusters, else
// two, each on its own tile). Each block streams its own members' 3xTF32
// images (W_hi and W_lo, packed by the host) from L2 through a ring of 32 KB
// shared-memory slots, filled by the first thread of each warpgroup; every
// product is a_lo w_hi + a_hi w_lo + a_hi w_hi, wgmma m64n128k8 (m64n8k8
// for the last layer's groups of 8 columns) with the activations' hi and lo
// parts in registers. A peer sends each member's last-layer output into
// rings in the leader block's shared memory (distributed shared memory),
// and the leader folds the members in member order into sums shifted by
// member 0's output: the arithmetic above, the same bits whatever B.
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
#include "fused_chain_wgmma.cuh"

namespace {

namespace fw = fused_chain_wgmma;

// The fp32 kernel (3xTF32). images: each member's chain image
// (ops/fused_eval_chain.py chain_image of the fp32 weights), member-major;
// b_all (L, M, 128); relu[l] != 0: ReLU after layer l; lay: the launch
// layout (eval_layout('ensemble', ..., fp32=True)).
__global__ void __launch_bounds__(2 * fw::kWgThreads, 1)
    fused_ensemble_kernel(const float* __restrict__ x, long long B, int d,
                          const unsigned char* __restrict__ images,
                          const float* __restrict__ b_all, int M, int L,
                          const int* __restrict__ relu, int out_dim,
                          float* __restrict__ mean, float* __restrict__ std,
                          fw::EnsembleLayout lay) {
  extern __shared__ __align__(128) unsigned char smem_tf[];
  fw::ensemble_tf32(smem_tf, x, B, d, images, b_all, M, L, relu, out_dim,
                    mean, std, lay);
}

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

// Launch on `stream`; returns a cudaError_t (0 on success). The caller
// checks d >= 1, 1 <= out_dim <= 128, every hidden width <= 128 (zero-padded
// to 128 in b_all), L >= 1, M >= 1, B >= 1, fp32 contiguous device buffers,
// relu as L int32 flags on the device, and allocates mean/std as
// (B, out_dim). images: the members' 3xTF32 chain images
// (ops/fused_eval_chain.py chain_image of the fp32 weights, member-major);
// layout: the launch layout (eval_layout('ensemble', ..., fp32=True),
// ENSEMBLE_FIELDS) as host ints.
int nnueehcs_fused_ensemble_f32(const float* x, long long B, int d,
                                const unsigned char* images,
                                const float* b_all, int M, int L,
                                const int* relu, int out_dim, float* mean,
                                float* std, const int* layout, void* stream) {
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  return static_cast<int>(fw::launch_cluster(
      fused_ensemble_kernel, lay, static_cast<cudaStream_t>(stream), x, B, d,
      images, b_all, M, L, relu, out_dim, mean, std, lay));
}

// The clusters of the fp32 kernel at the layout `layout` that the card runs
// at once, or minus a cudaError_t.
int nnueehcs_fused_ensemble_f32_clusters(const int* layout) {
  return fw::max_clusters(fused_ensemble_kernel,
                          fw::EnsembleLayout::from(layout));
}

// The bf16 form: as nnueehcs_fused_ensemble_f32 with the members' bf16
// chain images (ops/fused_eval_chain.py chain_image, member-major) and the
// bf16 form's launch layout (eval_layout('ensemble', ...)).
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
