// Fused MC-dropout UE pass for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/fused_ensemble.py::_fused_mc_kernel (the Pallas
// TPU kernel). Same function: for each tile of rows, one BatchNorm-folded
// Linear(+ReLU) chain run S times, sample s with a keep mask scaled by
// 1/keep on the input of every Linear that had a Dropout before it; mean
// and unbiased std over the S samples. Only the (B, out_dim) mean and std
// are written to device memory.
//
// The masks: the TPU kernel draws from the chip's hardware PRNG; this kernel
// hashes (call seed, sample, Dropout module index, global row, column)
// through the lowbias32 finalizer, exactly as the plain version
// (ops/fused_mc_dropout.py) does in int64 tensor ops, so the two draw the
// same masks. A row's global index is row_base plus its index in the call:
// a caller that splits one request's rows over several launches (a rank's
// share of a dp-sharded request) passes its first row, and draws the
// masks the whole request would. A value is kept when the top 24 bits of its hash are below
// keep * 2^24.
//
// A seed table (seeds, rows_per_seed; a batched validation pass, one seed
// a batch) makes global row R draw with seeds[R / rows_per_seed] at hash
// row R % rows_per_seed: exactly what a launch of that batch alone draws
// with its seed and row_base 0 (drop_for: the tile's group's seed when the
// tile lies in one group, each row's own otherwise).
//
// What bounds it on an H100: operations. The flagship (5 inputs, 7 Linear
// layers 128 wide, S = 128) does 82,688 multiply-adds per row per sample
// against 28 bytes moved per row. Its products run as 3xTF32 on the tensor
// cores (fused_chain_wgmma.cuh, its fp32 section): three TF32 products per
// fp32 one at the dense TF32 peak (495 TFLOP/s on an H100 SXM), 33.6 ms at
// the flagship on 262,144 rows, with the mask hash (9.0 ms on the ALU pipe,
// as the bf16 form's) under it; the fp32 FFMA floor was 83.5 ms.
//
// What the design does about it (fused_mc_dropout_kernel): the chain's
// 3xTF32 image (W_hi, W_lo; 656 KB at the flagship) streams from L2
// through a ring of shared-memory slots, filled by the first thread of each
// warpgroup, into two consumer warpgroups (one where 128 outputs'
// statistics leave no room), each on its own tile, both through the same
// blocks, with wgmma m64n128k8 products and the activations' hi and lo
// parts in registers; each layer's keep bits for the next Linear are
// hashed while the layer's last products fly, as the bf16 form does. No
// branch on a value ptxas cannot tell the warpgroup shares comes before
// the registers a product reads (selects instead), or ptxas serialises
// every product of the kernel (C7520). A 64-row tile's S samples are split
// into kGroups = 8 groups (the first S % 8 one sample more), one for each
// block of a thread-block cluster of 8, so a small request and a
// validation pass still fill the card: a 128-row request runs on 8 SMs (16
// warpgroups), not 2. The groups are a constant of the kernel, so a row's
// arithmetic does not depend on B, row_base or the seed table. There is no
// dropout-free pass: each group takes its own first sample as the shift of
// its sums s1 = sum (h - c), s2 = sum (h - c)^2; the leader block (rank 0)
// merges the groups' means and M2 in group order by Chan's formula, the
// peers' through their exchange rings in its shared memory (distributed
// shared memory), and writes mean and std = sqrt(max(M2, 0) / max(S - 1,
// 1)).
//
// The bf16 form (fused_mc_dropout_bf16_kernel) replaces the same TPU kernel
// run with compute_dtype=bfloat16: the masks and their 1/keep scale are
// applied in fp32 and the activation is rounded to bf16 only at the next
// dot, so the epilogue masks the fp32 value before it rounds; the
// dropout-free shift pass runs in bf16 too, and the masks are the same hash.
// What bounds it: the bf16 products at the dense tensor-core peak (989
// TFLOP/s on an H100 SXM, 5.7 ms at the flagship) and the mask hash, 11
// integer operations for each of the 2.1e10 masked elements, 7 of which
// only the ALU pipe runs (64 a clock per SM; ops/fused_mc_dropout.py
// MASK_HASH_OPS), 9.0 ms at the flagship. Its design is
// fused_chain_wgmma.cuh's: persistent blocks holding the chain in shared
// memory, warpgroups of wgmma products with the activations in registers,
// three warpgroups a block so that two's epilogues and hashes overlap the
// third's products; each layer's keep bits for the next Linear are hashed
// while the layer's products are in flight, packed 64 to two words, and
// applied in the epilogue. A launch with a seed table runs the same body as
// fused_mc_dropout_bf16_table_kernel, which looks its tiles' seeds up and
// forms each layer's mask words before the layer's products are issued;
// the serving kernel keeps its code and schedule.
#include "fused_chain_wgmma.cuh"

namespace {

__host__ __device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The stream word of one Dropout (module index key) in dropout sample p - 1
// drawn with `seed`.
__device__ __forceinline__ uint32_t mask_stream(uint32_t seed, int p,
                                                int key) {
  return lowbias32(lowbias32(seed + static_cast<uint32_t>(p - 1) * 0x9E3779B9u) +
                   static_cast<uint32_t>(key) * 0x85EBCA6Bu);
}

namespace fw = fused_chain_wgmma;

// One Dropout's mask in one sample, for a thread's two rows (r0, r0 + 8 of
// the tile): bq[h] = stream + row term + column 2 q's term, so that value
// (h, column 2 q + o) keeps when the top 24 bits of lowbias32(bq[h] +
// o * 0x27D4EB2F) fall below the threshold, as the plain version's.
struct Drop {
  bool active;
  uint32_t threshold;
  float scale;
  uint32_t col;     // 2 q, the column bq includes
  uint32_t bq[2];

  __device__ __forceinline__ bool keep(int h, uint32_t o) const {
    return (lowbias32(bq[h] + o * 0x27D4EB2Fu) >> 8) < threshold;
  }
  // value (h, column c) of x through the mask
  __device__ __forceinline__ float operator()(int h, int c, float v) const {
    if (!active) return v;
    return v * (keep(h, static_cast<uint32_t>(c) - col) ? scale : 0.f);
  }
};

// The thread's two rows of the tile whose first row is global row `first`
// (`valid` rows) take their stream words from `seed`, or (kTable) from the
// seed table: the tile's group's seed when the tile lies in one group,
// each row's own otherwise. With a table all of it is derived anew in each
// call from `first` (pinned, so nothing is hoisted out of the pass loop):
// the resident form runs at its register cap.
template <bool kTable>
__device__ __forceinline__ Drop drop_for(int p, int l, uint32_t seed,
                                         const uint32_t* seeds,
                                         uint32_t rows_per_seed,
                                         uint32_t first, int valid,
                                         const int* thresh,
                                         const float* scale, const int* key,
                                         const fw::Thread& t) {
  Drop m;
  const int th = __ldg(thresh + l);
  const int k = __ldg(key + l);
  m.active = p > 0 && th >= 0;
  m.threshold = static_cast<uint32_t>(th);
  m.scale = __ldg(scale + l);
  m.col = static_cast<uint32_t>(2 * t.q);
  if (kTable) fw::pin(first);
  uint32_t hash_row0 = first;
  if (kTable && seeds != nullptr && valid > 0) {
    const uint32_t g = first / rows_per_seed;
    hash_row0 = first - g * rows_per_seed;
    if (hash_row0 + static_cast<uint32_t>(valid) > rows_per_seed) {
      // the tile spans groups: each row its own seed
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t at =
            hash_row0 + static_cast<uint32_t>(min(t.r0 + 8 * h, valid - 1));
        const uint32_t gh = at / rows_per_seed;
        m.bq[h] = mask_stream(__ldg(seeds + g + gh), p, k) +
                  (at - gh * rows_per_seed) * 0xC2B2AE35u +
                  m.col * 0x27D4EB2Fu;
      }
      return m;
    }
    seed = __ldg(seeds + g);
  }
  const uint32_t stream = mask_stream(seed, p, k);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    m.bq[h] = stream +
              (hash_row0 + static_cast<uint32_t>(t.r0 + 8 * h)) *
                  0xC2B2AE35u +
              m.col * 0x27D4EB2Fu;
  return m;
}

// The keep bits of the thread's 64 accumulator slots (fw::keep_bit). A
// value keeps when the top 24 bits of its hash fall below the threshold,
// that is when (bits >> 8) - threshold is negative (both lie in [0, 2^24]);
// a funnel shift moves that sign bit into the byte of its (h, e) pair. Two
// column groups a step: eight hashes in flight per thread keep the INT32
// pipes busy without the registers of all 64.
__device__ __forceinline__ void keep_words(const Drop& m, uint32_t (&w)[2]) {
  STAMP(4);
  uint32_t b0 = m.bq[0], b1 = m.bq[1];
  fw::pin(b0);   // not before the products are issued
  fw::pin(b1);
#pragma unroll
  for (int word = 0; word < 2; ++word) {
    uint32_t k[4] = {0u, 0u, 0u, 0u};
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const uint32_t col = 8u * (8 * word + i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t bits =
              lowbias32((h ? b1 : b0) + (col + e) * 0x27D4EB2Fu);
          k[2 * h + e] =
              __funnelshift_l((bits >> 8) - m.threshold, k[2 * h + e], 1);
        }
      }
    }
    w[word] = k[0] | (k[1] << 8) | (k[2] << 16) | (k[3] << 24);
  }
  fw::pin(w[0]);  // formed before the wait
  fw::pin(w[1]);
}

__device__ __forceinline__ void mask_epilogue(const float (&acc)[64],
                                              const float* bias, bool relu,
                                              const Drop& m,
                                              const uint32_t (&keep)[2],
                                              const fw::Thread& t,
                                              uint32_t (&a)[8][4]) {
  if (m.active)
    fw::epilogue<true, true>(acc, bias, relu, keep, m.scale, t, a);
  else
    fw::epilogue<false, true>(acc, bias, relu, keep, m.scale, t, a);
}

// The fp32 kernel's epilogue: an inactive mask as keep bits of all ones
// and a scale of 1 (the same values; fw::epilogue_tf32).
__device__ __forceinline__ void mask_epilogue_tf32(const float (&acc)[64],
                                                   const float* bias,
                                                   bool relu, const Drop& m,
                                                   const uint32_t (&keep)[2],
                                                   const fw::Thread& t,
                                                   uint32_t (&hi)[16][4],
                                                   uint32_t (&lo)[16][4]) {
  const uint32_t k[2] = {m.active ? keep[0] : ~0u, m.active ? keep[1] : ~0u};
  fw::epilogue_tf32(acc, bias, fw::relu_floor(relu), k,
                    m.active ? m.scale : 1.f, t, hi, lo);
}

// The bf16 form's body. image: the chain packed by ops/fused_eval_chain.py
// (chain_image); b_all (L, 128) fp32; relu, thresh, scale, key as for the
// fp32 kernel; lay: the launch layout (eval_layout). kTable: the masks
// come from the seed table (seeds, rows_per_seed); the form without it is
// the serving path's, whose code and schedule it leaves as they were.
template <bool kRing, bool kTable>
__device__ __forceinline__ void mc_bf16_body(
    const float* __restrict__ x, long long B, int d,
    const unsigned char* __restrict__ image, const float* __restrict__ b_all,
    int L, const int* __restrict__ relu, const int* __restrict__ thresh,
    const float* __restrict__ scale, const int* __restrict__ key, int S,
    uint32_t seed, uint32_t row_base, const uint32_t* __restrict__ seeds,
    uint32_t rows_per_seed, int out_dim, float* __restrict__ mean,
    float* __restrict__ std, const fw::Layout& lay) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  const fw::Chain chain(d, L, lay.out_groups);
  fw::Weights<kRing> wts(smem_wg, lay);
  const int wg = threadIdx.x / fw::kWgThreads;
  if (threadIdx.x == 0) wts.init(lay.warpgroups);
  __syncthreads();
  const fw::Tiles tiles(B, lay, wg);
  if (kRing && wg == lay.warpgroups) {  // the ring's producer warp
    if (threadIdx.x % 32 == 0)
      for (int r = 0; r < tiles.rounds; ++r)
        for (int p = 0; p <= S; ++p) {
          if (L == 1) {  // layer 0 once for each column group
            for (int g = 0; g < lay.out_groups; ++g)
              for (int b = 0; b < chain.nb0; ++b) wts.produce(chain, image, b);
          } else {
            for (int b = 0; b < chain.blocks(); ++b)
              wts.produce(chain, image, b);
          }
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
  const bool relu_last = __ldg(relu + last) != 0;
  float acc[64], acc_last[4];   // written by each layer's first product
  uint32_t a[8][4];
  for (int r = 0;; ++r) {
    const int tile = tiles.tile<kRing>(r);
    if (tile < 0) break;
    const long long row0 = static_cast<long long>(tile) * fw::kRows;
    const int valid = tiles.valid(tile, B);
    const float* x_tile = x + (valid > 0 ? row0 * d : 0);
    const uint32_t first = static_cast<uint32_t>(row0) + row_base;
    const auto drop = [&](int p, int l) {
      return drop_for<kTable>(p, l, seed, seeds, rows_per_seed, first, valid,
                              thresh, scale, key, t);
    };
    for (int p = 0; p <= S; ++p) {
      const Drop m0 = drop(p, 0);
      if (L == 1) {  // one Linear: the last layer straight from x
        for (int g = 0; g < groups; ++g) {
          fw::last_group_from_x(acc_last, wts, chain, x_tile, d, d, valid, t,
                                g, m0);
          fw::stats_update(acc_last, b_last, relu_last, g, t, p == 0, st);
        }
        continue;
      }
      Drop m = drop(p, 1);
      uint32_t keep[2] = {0u, 0u};
      fw::layer0_from_x(acc, wts, chain, x_tile, d, d, valid, t, m0, [&] {
        if (m.active) keep_words(m, keep);
      });
      mask_epilogue(acc, b_all, __ldg(relu) != 0, m, keep, t, a);
      for (int l = 1; l < last; ++l) {
        // a table's mask words before the products, while the accumulator
        // is free (after them the resident form spilled); without one,
        // after them, as they fly
        if (kTable) m = drop(p, l + 1);
        const uint32_t addr = wts.acquire(chain, chain.nb0 + l - 1);
        fw::issue_n128(acc, a, addr);
        if (!kTable) m = drop(p, l + 1);
        if (m.active) keep_words(m, keep);
        fw::wait_acc(acc, a);
        wts.release(t.lane0);
        mask_epilogue(acc, b_all + static_cast<size_t>(l) * fw::kWidth,
                      __ldg(relu + l) != 0, m, keep, t, a);
      }
      const uint32_t addr = wts.acquire(chain, chain.nb0 + last - 1);
      for (int g = 0; g < groups; ++g) {
        fw::last_group(acc_last, a, addr, g);
        fw::stats_update(acc_last, b_last, relu_last, g, t, p == 0, st);
      }
      wts.release(t.lane0);
    }
    fw::stats_write(st, groups, S, t, valid, row0, out_dim, out_dim, mean,
                    std);
  }
  STAMP_END();
}

// The fp32 kernel (3xTF32; fused_chain_wgmma.cuh's fp32 section). image:
// the chain's 3xTF32 image (chain_image of fp32 weights); b_all (L, 128);
// relu, thresh, scale, key as for the bf16 form; lay: the launch layout
// (eval_layout(..., fp32=True)): clusters of kGroups blocks, block `rank`
// of a cluster running group `rank` of the samples of each of its
// warpgroups' tiles.
__global__ void __launch_bounds__(2 * fw::kWgThreads, 1)
    fused_mc_dropout_kernel(
        const float* __restrict__ x, long long B, int d,
        const unsigned char* __restrict__ image,
        const float* __restrict__ b_all, int L, const int* __restrict__ relu,
        const int* __restrict__ thresh, const float* __restrict__ scale,
        const int* __restrict__ key, int S, uint32_t seed, uint32_t row_base,
        const uint32_t* __restrict__ seeds, uint32_t rows_per_seed,
        int out_dim, float* __restrict__ mean, float* __restrict__ std,
        fw::EnsembleLayout lay) {
  extern __shared__ __align__(128) unsigned char smem_tf[];
  const fw::Chain32 chain(d, L, lay.base.out_groups);
  fw::Ring<> ring(smem_tf, lay.base);
  const int rank = static_cast<int>(fw::cluster_rank());
  const int wg = threadIdx.x / fw::kWgThreads;
  const fw::Tiles tiles(B, lay.base, wg,
                        static_cast<int>(gridDim.x) / fw::kGroups,
                        static_cast<int>(blockIdx.x) / fw::kGroups);
  const int passes = fw::group_size(S, rank);
  const int first = fw::group_first(S, rank);
  if (threadIdx.x == 0) {
    fw::Exchange::init(smem_tf, lay);
    ring.init(lay.base.warpgroups, image, chain,
              static_cast<uint32_t>(tiles.rounds) * passes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fw::cluster_sync();   // every block's barriers are set before a peer's use
  if (passes > 0) {
    STAMP_BEGIN(true, 0);
    const fw::Thread t(threadIdx.x);
    fw::Exchange ex(smem_tf, lay, wg, out_dim);
    const int groups = lay.base.out_groups;
    float4* st = reinterpret_cast<float4*>(smem_tf + lay.base.smem_stats) +
                 (wg * groups * 3) * fw::kWgThreads + t.lt;
    const int last = L - 1;
    const float* b_last = b_all + static_cast<size_t>(last) * fw::kWidth;
    const bool relu_last = __ldg(relu + last) != 0;
    float acc[64], acc_last[4];   // written by each layer's first product
    uint32_t hi[16][4], lo[16][4];
    for (int r = 0; r < tiles.rounds; ++r) {
      // every warpgroup takes every round's blocks, past the last tile as
      // a tile of no rows
      const int tile = tiles.tile<true>(r);
      const long long row0 = static_cast<long long>(tile) * fw::kRows;
      const int valid = tiles.valid(tile, B);
      const float* x_tile = x + (valid > 0 ? row0 * d : 0);
      const uint32_t first_row = static_cast<uint32_t>(row0) + row_base;
      const auto drop = [&](int p, int l) {
        return drop_for<true>(p, l, seed, seeds, rows_per_seed, first_row,
                              valid, thresh, scale, key, t);
      };
      for (int i = 0; i < passes; ++i) {
        const int p = first + i + 1;   // pass p draws sample p - 1
        const Drop m0 = drop(p, 0);
        if (L == 1) {   // one Linear: the last layer straight from x
          for (int g = 0; g < groups; ++g) {
            fw::x_group_tf32(acc_last, ring, chain, x_tile, d, d, valid, t,
                             m0);
            fw::stats_update(acc_last, b_last, relu_last, g, t, i == 0, st);
          }
          continue;
        }
        // each layer's mask for the next Linear is drawn while the layer's
        // last products fly, not held through the ring's waits (the
        // registers run at the cap)
        Drop m;
        uint32_t keep[2] = {0u, 0u};
        fw::x_layer_tf32(acc, ring, chain, x_tile, d, d, valid, t, m0, [&] {
          m = drop(p, 1);
          if (m.active) keep_words(m, keep);
        });
        mask_epilogue_tf32(acc, b_all, __ldg(relu) != 0, m, keep, t, hi, lo);
        for (int l = 1; l < last; ++l) {
          fw::hidden_tf32(acc, hi, lo, ring, t, [&] {
            m = drop(p, l + 1);
            if (m.active) keep_words(m, keep);
          });
          mask_epilogue_tf32(acc, b_all + static_cast<size_t>(l) * fw::kWidth,
                             __ldg(relu + l) != 0, m, keep, t, hi, lo);
        }
        for (int g = 0; g < groups; ++g) {
          fw::last_group_tf32(acc_last, hi, lo, ring, t);
          fw::stats_update(acc_last, b_last, relu_last, g, t, i == 0, st);
        }
      }
      fw::merge_groups(ex, st, groups, S, rank, static_cast<uint32_t>(r), t,
                       valid, row0, out_dim, mean, std);
    }
    STAMP_END();
  }
  fw::cluster_sync();   // no block leaves while a peer may still reach into it
}

#define MC_BF16_PARAMS                                                       \
  const float* __restrict__ x, long long B, int d,                           \
      const unsigned char* __restrict__ image,                               \
      const float* __restrict__ b_all, int L, const int* __restrict__ relu,  \
      const int* __restrict__ thresh, const float* __restrict__ scale,       \
      const int* __restrict__ key, int S, uint32_t seed, uint32_t row_base,  \
      const uint32_t* __restrict__ seeds, uint32_t rows_per_seed,            \
      int out_dim, float* __restrict__ mean, float* __restrict__ std,        \
      fw::Layout lay
#define MC_BF16_ARGS                                                         \
  x, B, d, image, b_all, L, relu, thresh, scale, key, S, seed, row_base,     \
      seeds, rows_per_seed, out_dim, mean, std, lay

// The serving path's bf16 kernel (one seed a call) and the batched
// validation pass's (a seed table).
template <bool kRing>
__global__ void __launch_bounds__(kRing ? fw::kWgThreads + 32 : 3 * fw::kWgThreads, 1)
    fused_mc_dropout_bf16_kernel(MC_BF16_PARAMS) {
  mc_bf16_body<kRing, false>(MC_BF16_ARGS);
}

template <bool kRing>
__global__ void __launch_bounds__(kRing ? fw::kWgThreads + 32 : 3 * fw::kWgThreads, 1)
    fused_mc_dropout_bf16_table_kernel(MC_BF16_PARAMS) {
  mc_bf16_body<kRing, true>(MC_BF16_ARGS);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks d >= 1, 1 <= out_dim <= 128, every hidden width <= 128 (zero-padded
// to 128), L >= 1, S >= 1, B >= 1, fp32 contiguous device buffers,
// relu/thresh/key as L int32 and scale as L float32 values on the device,
// and allocates mean/std as (B, out_dim). image: the chain's 3xTF32 image
// (ops/fused_eval_chain.py chain_image of the fp32 weights); b_all (L, 128);
// layout: the launch layout (eval_layout(..., fp32=True), ENSEMBLE_FIELDS)
// as host ints. row_base is the global index of x's first row in the
// masks' hash. seeds: null, or a device table of uint32 seeds, one for each
// rows_per_seed (>= 1) global rows, that covers every row of the launch.
int nnueehcs_fused_mc_dropout_f32(const float* x, long long B, int d,
                                  const unsigned char* image,
                                  const float* b_all, int L, const int* relu,
                                  const int* thresh, const float* scale,
                                  const int* key, int S, uint32_t seed,
                                  uint32_t row_base, const uint32_t* seeds,
                                  uint32_t rows_per_seed, int out_dim,
                                  float* mean, float* std, const int* layout,
                                  void* stream) {
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  return static_cast<int>(fw::launch_cluster(
      fused_mc_dropout_kernel, lay, static_cast<cudaStream_t>(stream), x, B,
      d, image, b_all, L, relu, thresh, scale, key, S, seed, row_base, seeds,
      rows_per_seed, out_dim, mean, std, lay));
}

// The clusters of the fp32 kernel at the layout `layout` that the card runs
// at once, or minus a cudaError_t.
int nnueehcs_fused_mc_dropout_f32_clusters(const int* layout) {
  return fw::max_clusters(fused_mc_dropout_kernel,
                          fw::EnsembleLayout::from(layout));
}

// The bf16 form: as nnueehcs_fused_mc_dropout_f32 with the chain as its
// bf16 image (ops/fused_eval_chain.py chain_image) in place of w_all, and
// the launch layout (eval_layout, LAYOUT_FIELDS) as host ints.
int nnueehcs_fused_mc_dropout_bf16(const float* x, long long B, int d,
                                   const unsigned char* image,
                                   const float* b_all, int L, const int* relu,
                                   const int* thresh, const float* scale,
                                   const int* key, int S, uint32_t seed,
                                   uint32_t row_base, const uint32_t* seeds,
                                   uint32_t rows_per_seed, int out_dim,
                                   float* mean, float* std,
                                   const int* layout, void* stream) {
  const fused_chain_wgmma::Layout lay = fused_chain_wgmma::Layout::from(layout);
  const auto kernel =
      seeds != nullptr
          ? (lay.ring ? fused_mc_dropout_bf16_table_kernel<true>
                      : fused_mc_dropout_bf16_table_kernel<false>)
          : (lay.ring ? fused_mc_dropout_bf16_kernel<true>
                      : fused_mc_dropout_bf16_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<lay.grid, lay.threads, lay.smem_bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, B, d, image, b_all, L, relu, thresh, scale, key, S, seed, row_base,
      seeds, rows_per_seed, out_dim, mean, std, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

STAMPS_READER(fused_mc_dropout)
