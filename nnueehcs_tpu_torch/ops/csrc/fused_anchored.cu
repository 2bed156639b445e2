// Fused anchored (Delta-UQ / PAGER) UE pass for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/fused_anchored.py::_anchored_kernel (the Pallas
// TPU kernel). Same function: the anchored input concat([a, x - a]) meets
// the first Linear as x @ W_bot + a @ (W_top - W_bot), so u = x @ W_bot +
// b0 serves every anchor; for anchor j, h = relu0(u + v_j) with
// v_j = a_j @ (W_top - W_bot) (computed by the caller, one (k, 128) array),
// then the rest of the BatchNorm-folded Linear(+ReLU) chain; mean and
// unbiased std over the k anchors. Only the (B, out_dim) mean and std are
// written to device memory; no (k, B, 2d) anchored input exists anywhere.
//
// What bounds it on an H100: operations. The flagship Delta-UQ net (5
// inputs doubled to 10, 7 Linear layers 128 wide, 229 anchors) does 640
// multiply-adds per row once plus 82,048 per row per anchor, against 28
// bytes moved per row. Its products run as 3xTF32 on the tensor cores
// (fused_chain_wgmma.cuh, its fp32 section): three TF32 products per fp32
// one at the dense TF32 peak (495 TFLOP/s on an H100 SXM), 14.9 ms at the
// flagship on 65,536 rows; the fp32 FFMA floor was 36.8 ms.
//
// What the design does about it (fused_anchored_kernel): kernel 2's (in
// fused_mc_dropout.cu) without masks: the chain's 3xTF32 image streams from
// L2 through a ring of shared-memory slots, filled by the first thread of
// each warpgroup, into two consumer warpgroups, each on its own tile, with
// wgmma m64n128k8 products and the activations' hi and lo parts in
// registers. Each anchor's layer 0 is relu(u + v_j) in fp32, u = x @ W_bot
// + b0 computed again for each anchor (one k step at the flagship's 5
// inputs; no shared memory beside the ring for it), split into A, with v_j
// read through L1. A 64-row tile's k anchors are split into kGroups = 8
// groups (the first k % 8 one anchor more), one for each block of a
// thread-block cluster of 8, so a small request and a validation pass
// still fill the card: a 128-row batch runs on 8 SMs (16 warpgroups), not
// 2. The groups are a constant of the kernel, so a row's arithmetic does
// not depend on B. Each group's shifted sums take its first anchor as the
// shift; the leader block (rank 0) merges the groups' means and M2 in
// group order by Chan's formula (the peers' through their exchange rings
// in its shared memory) and writes mean and std = sqrt(max(M2, 0) /
// max(k - 1, 1)).
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
#include "fused_chain_wgmma.cuh"

namespace {

namespace fw = fused_chain_wgmma;

// The fp32 kernel (3xTF32). image: the chain's 3xTF32 image (chain_image of
// the fp32 weights, W_bot as layer 0); b_all (L, 128) with b0 first; relu[l]
// != 0: ReLU after layer l (after adding v_j for layer 0); v (k, 128), zero
// past layer 0's width; lay: the launch layout (eval_layout(...,
// fp32=True)): clusters of kGroups blocks, block `rank` of a cluster running
// group `rank` of the anchors of each of its warpgroups' tiles.
__global__ void __launch_bounds__(2 * fw::kWgThreads, 1)
    fused_anchored_kernel(const float* __restrict__ x, long long B, int d,
                          const unsigned char* __restrict__ image,
                          const float* __restrict__ b_all, int L,
                          const int* __restrict__ relu,
                          const float* __restrict__ v, int k, int out_dim,
                          float* __restrict__ mean, float* __restrict__ std,
                          fw::EnsembleLayout lay) {
  extern __shared__ __align__(128) unsigned char smem_tf[];
  const fw::Chain32 chain(d, L, lay.base.out_groups);
  fw::Ring<> ring(smem_tf, lay.base);
  const int rank = static_cast<int>(fw::cluster_rank());
  const int wg = threadIdx.x / fw::kWgThreads;
  const fw::Tiles tiles(B, lay.base, wg,
                        static_cast<int>(gridDim.x) / fw::kGroups,
                        static_cast<int>(blockIdx.x) / fw::kGroups);
  const int anchors = fw::group_size(k, rank);
  const int first = fw::group_first(k, rank);
  if (threadIdx.x == 0) {
    fw::Exchange::init(smem_tf, lay);
    ring.init(lay.base.warpgroups, image, chain,
              static_cast<uint32_t>(tiles.rounds) * anchors);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fw::cluster_sync();   // every block's barriers are set before a peer's use
  if (anchors > 0) {
    STAMP_BEGIN(true, 0);
    const fw::Thread t(threadIdx.x);
    fw::Exchange ex(smem_tf, lay, wg, out_dim);
    const int groups = lay.base.out_groups;
    float4* st = reinterpret_cast<float4*>(smem_tf + lay.base.smem_stats) +
                 (wg * groups * 3) * fw::kWgThreads + t.lt;
    const int last = L - 1;
    const float* b_last = b_all + static_cast<size_t>(last) * fw::kWidth;
    const float floor0 = fw::relu_floor(__ldg(relu) != 0);
    const bool relu_last = __ldg(relu + last) != 0;
    const uint32_t all[2] = {~0u, ~0u};
    float acc[64], acc_last[4];   // written by each layer's first product
    uint32_t hi[16][4], lo[16][4];
    for (int r = 0; r < tiles.rounds; ++r) {
      // every warpgroup takes every round's blocks, past the last tile as
      // a tile of no rows
      const int tile = tiles.tile<true>(r);
      const long long row0 = static_cast<long long>(tile) * fw::kRows;
      const int valid = tiles.valid(tile, B);
      const float* x_tile = x + (valid > 0 ? row0 * d : 0);
      for (int j = first; j < first + anchors; ++j) {
        // layer 0 of anchor j: relu(x @ W_bot + b0 + v_j), split into A
        // (x @ W_bot again for each anchor: one k step at d <= 8, and no
        // shared memory for u beside the ring)
        fw::x_layer_tf32(acc, ring, chain, x_tile, d, d, valid, t,
                         fw::NoMask(), [] {});
        fw::anchor_epilogue_tf32(acc, b_all,
                                 v + static_cast<size_t>(j) * fw::kWidth,
                                 floor0, t, hi, lo);
        for (int l = 1; l < last; ++l) {
          fw::hidden_tf32(acc, hi, lo, ring, t, [] {});
          fw::epilogue_tf32(acc, b_all + static_cast<size_t>(l) * fw::kWidth,
                            fw::relu_floor(__ldg(relu + l) != 0), all, 1.f,
                            t, hi, lo);
        }
        for (int g = 0; g < groups; ++g) {
          fw::last_group_tf32(acc_last, hi, lo, ring, t);
          fw::stats_update(acc_last, b_last, relu_last, g, t, j == first, st);
        }
      }
      fw::merge_groups(ex, st, groups, k, rank, static_cast<uint32_t>(r), t,
                       valid, row0, out_dim, mean, std);
    }
    STAMP_END();
  }
  fw::cluster_sync();   // no block leaves while a peer may still reach into it
}

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
// (zero-padded to 128 in b_all/v), k >= 1, B >= 1, fp32 contiguous device
// buffers, relu as L int32 flags on the device, and allocates mean/std as
// (B, out_dim). image: the chain's 3xTF32 image (ops/fused_eval_chain.py
// chain_image of the fp32 weights); layout: the launch layout
// (eval_layout(..., fp32=True), ENSEMBLE_FIELDS) as host ints.
int nnueehcs_fused_anchored_f32(const float* x, long long B, int d,
                                const unsigned char* image,
                                const float* b_all, int L, const int* relu,
                                const float* v, int k, int out_dim,
                                float* mean, float* std, const int* layout,
                                void* stream) {
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  return static_cast<int>(fw::launch_cluster(
      fused_anchored_kernel, lay, static_cast<cudaStream_t>(stream), x, B, d,
      image, b_all, L, relu, v, k, out_dim, mean, std, lay));
}

// The clusters of the fp32 kernel at the layout `layout` that the card runs
// at once, or minus a cudaError_t.
int nnueehcs_fused_anchored_f32_clusters(const int* layout) {
  return fw::max_clusters(fused_anchored_kernel,
                          fw::EnsembleLayout::from(layout));
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
