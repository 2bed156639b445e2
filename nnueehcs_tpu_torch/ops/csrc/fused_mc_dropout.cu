// Fused MC-dropout UE pass for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/fused_ensemble.py::_fused_mc_kernel (the Pallas
// TPU kernel). Same function: for each tile of rows, one BatchNorm-folded
// Linear(+ReLU) chain run 1 + S times. Pass 0 runs without dropout and its
// output is the shift c; pass p >= 1 is dropout sample p - 1, where the
// input of every Linear that had a Dropout before it is multiplied by a keep
// mask scaled by 1/keep. s1 = sum (h - c) and s2 = sum (h - c)^2 over the S
// samples give mean = c + s1/S and std = sqrt(max(s2 - S*m1^2, 0)/(S-1)).
// Only the (B, out_dim) mean and std are written to device memory.
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
// with its seed and row_base 0. The stream word is per tile when the
// tile's rows share one seed (every batch size that is a multiple of the
// 64-row tile), and per row in a tile that spans two groups or more.
//
// What bounds it on an H100: operations. The flagship (5 inputs, 7 Linear
// layers 128 wide, S = 128) does 82,688 multiply-adds per row per pass, 129
// passes, against 28 bytes moved per row; the fp32 FFMA peak (67 TFLOP/s at
// 700 W) is the floor.
//
// What the design does about it: the tile machinery of the ensemble kernel
// (fused_chain.cuh), with the pass loop in place of the member loop and one
// set of weights streamed from L2 for every pass. Masks are generated in
// registers where they are applied, in the epilogue of the layer before
// (or as x is staged, for a Dropout before layer 0), so no mask bytes touch
// memory; the hash costs about a dozen integer operations per element
// against the 128 FMAs that produced it.
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
#include "fused_chain.cuh"
#include "fused_chain_wgmma.cuh"

using namespace fused_chain;

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

// The seeds of a tile's rows. A launch without a table draws every row
// with `seed` at its global row; with one, a tile inside one seed group
// draws with that group's seed at the rows' places in their group
// (per_row false), and a tile that spans groups looks each row's seed up
// (per_row true). rows past `valid` take the last valid row's seed.
struct TileSeeds {
  const uint32_t* seeds;   // the table, or null
  uint32_t rows_per_seed;
  uint32_t first;          // global row of the tile's first row
  int valid;
  bool per_row;
  uint32_t seed;           // the tile's seed when !per_row
  uint32_t hash_row0;      // hash row of the tile's first row when !per_row

  TileSeeds() = default;
  __device__ __forceinline__ TileSeeds(const uint32_t* table, uint32_t rps,
                                       uint32_t call_seed, uint32_t row,
                                       int rows)
      : seeds(table), rows_per_seed(rps), first(row), valid(rows),
        per_row(false), seed(call_seed), hash_row0(row) {
    if (table == nullptr || rows <= 0) return;
    const uint32_t g = row / rps;
    per_row = g != (row + static_cast<uint32_t>(rows - 1)) / rps;
    seed = __ldg(table + g);
    hash_row0 = row - g * rps;
  }
  // (stream word, hash row) of tile row r for one Dropout in one sample
  __device__ __forceinline__ uint2 row_stream(int r, int p, int key) const {
    const uint32_t row = first + static_cast<uint32_t>(min(r, valid - 1));
    const uint32_t g = row / rows_per_seed;
    return make_uint2(mask_stream(__ldg(seeds + g), p, key),
                      row - g * rows_per_seed);
  }
};

// Multiplies a value by its keep mask (scale or 0) for one Dropout in one
// sample; the identity when inactive (pass 0, or no Dropout).
struct DropMask {
  bool active;
  uint32_t stream;  // lowbias32(lowbias32(seed + sample*A) + key*B)
  uint32_t row0;    // hash row of the tile's first row (row_base added)
  uint32_t threshold;
  float scale;

  __device__ __forceinline__ float operator()(int r, int col, float v) const {
    if (!active) return v;
    const uint32_t bits =
        lowbias32(stream + (row0 + static_cast<uint32_t>(r)) * 0xC2B2AE35u +
                  static_cast<uint32_t>(col) * 0x27D4EB2Fu);
    return v * ((bits >> 8) < threshold ? scale : 0.f);
  }
};

// DropMask for a tile whose rows draw with several seeds of a table: each
// value hashes its own row's stream word.
struct RowDropMask {
  bool active;
  int p, key;
  TileSeeds rows;
  uint32_t threshold;
  float scale;

  __device__ __forceinline__ float operator()(int r, int col, float v) const {
    if (!active) return v;
    const uint2 sr = rows.row_stream(r, p, key);
    const uint32_t bits = lowbias32(sr.x + sr.y * 0xC2B2AE35u +
                                    static_cast<uint32_t>(col) * 0x27D4EB2Fu);
    return v * ((bits >> 8) < threshold ? scale : 0.f);
  }
};

// The 1 + S passes over one tile and its statistics; mask_for(p, l) gives
// the mask before Linear l in pass p.
template <class MaskFor>
__device__ __forceinline__ void mc_tile(float* smem, const float* x_tile,
                                        int d, int valid, long long row0,
                                        const float* w_all,
                                        const float* b_all, int L,
                                        const int* relu, int S, int out_dim,
                                        float* mean, float* std,
                                        const MaskFor& mask_for_pass) {
  float* act0 = smem;
  float* act1 = act0 + kWidth * kStride;
  float* sw = act1 + kWidth * kStride;
  float* sc = sw + 2 * kChunk * kWidth;
  float* s1 = sc + kTileRows * out_dim;
  float* s2 = s1 + kTileRows * out_dim;
  const float* w_hidden = w_all + static_cast<size_t>(d) * kWidth;
  const Identity none;

  for (int p = 0; p <= S; ++p) {
    const auto mask_for = [&](int l) { return mask_for_pass(p, l); };
    __syncthreads();  // the previous pass's last layer may still read act0
    float* in = act0;
    float* out = act1;
    for (int l = 0; l + 1 < L; ++l) {
      const float* b = b_all + static_cast<size_t>(l) * kWidth;
      const bool act = __ldg(relu + l) != 0;
      const auto next = mask_for(l + 1);
      if (l == 0) {
        dense_layer<true>(in, out, sw, w_all, b, d, act, x_tile, valid,
                          mask_for(0), next);
      } else {
        dense_layer<false>(in, out, sw,
                           w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth,
                           b, kWidth, act, nullptr, valid, none, next);
      }
      float* t = in;
      in = out;
      out = t;
    }
    __syncthreads();  // the last epilogue's stores must land before the reads
    const int l = L - 1;
    const float* b = b_all + static_cast<size_t>(l) * kWidth;
    const bool act = __ldg(relu + l) != 0;
    if (l == 0) {  // one Linear: read x straight from device memory
      last_layer_stats(x_tile, 1, d, valid, w_all, b, d, act, out_dim, p == 0,
                       sc, s1, s2, mask_for(0));
    } else {
      last_layer_stats(in, kStride, 1, valid,
                       w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth,
                       b, kWidth, act, out_dim, p == 0, sc, s1, s2, none);
    }
  }
  write_stats(sc, s1, s2, S, valid, row0, out_dim, mean, std);
}

// w_all: layer 0 as (d, 128), then layers 1..L-1 as (128, 128); b_all:
// (L, 128). relu[l] != 0: ReLU after layer l. thresh[l] >= 0: a Dropout
// with that keep threshold, scale[l] = 1/keep and module index key[l]
// comes before Linear l. seeds: the seed table (rows_per_seed rows a
// seed), or null for `seed` on every row.
__global__ void __launch_bounds__(kThreads, 2)
    fused_mc_dropout_kernel(const float* __restrict__ x, long long B, int d,
                            const float* __restrict__ w_all,
                            const float* __restrict__ b_all, int L,
                            const int* __restrict__ relu,
                            const int* __restrict__ thresh,
                            const float* __restrict__ scale,
                            const int* __restrict__ key, int S, uint32_t seed,
                            uint32_t row_base,
                            const uint32_t* __restrict__ seeds,
                            uint32_t rows_per_seed, int out_dim,
                            float* __restrict__ mean,
                            float* __restrict__ std) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kTileRows), B - row0));
  const float* x_tile = x + row0 * d;
  const TileSeeds rows(seeds, rows_per_seed, seed,
                       static_cast<uint32_t>(row0) + row_base, valid);
  if (rows.per_row) {
    mc_tile(smem, x_tile, d, valid, row0, w_all, b_all, L, relu, S, out_dim,
            mean, std, [&](int p, int l) {
              RowDropMask m;
              const int t = __ldg(thresh + l);
              m.active = p > 0 && t >= 0;
              m.p = p;
              m.key = __ldg(key + l);
              m.rows = rows;
              m.threshold = static_cast<uint32_t>(t);
              m.scale = __ldg(scale + l);
              return m;
            });
    return;
  }
  mc_tile(smem, x_tile, d, valid, row0, w_all, b_all, L, relu, S, out_dim,
          mean, std, [&](int p, int l) {
            DropMask m;
            const int t = __ldg(thresh + l);
            m.active = p > 0 && t >= 0;
            m.threshold = static_cast<uint32_t>(t);
            m.scale = __ldg(scale + l);
            m.row0 = rows.hash_row0;
            m.stream = mask_stream(rows.seed, p, __ldg(key + l));
            return m;
          });
}

namespace fw = fused_chain_wgmma;

// One Dropout's mask in one sample, for a thread's two rows (r0, r0 + 8 of
// the tile): bq[h] = stream + row term + column 2 q's term, so that value
// (h, column 2 q + o) keeps when the top 24 bits of lowbias32(bq[h] +
// o * 0x27D4EB2F) fall below the threshold, as DropMask's.
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
// to 128 in w_all/b_all), L >= 1, S >= 1, B >= 1, fp32 contiguous device
// buffers, relu/thresh/key as L int32 and scale as L float32 values on the
// device, and allocates mean/std as (B, out_dim). row_base is the global
// index of x's first row in the masks' hash. seeds: null, or a device table
// of uint32 seeds, one for each rows_per_seed (>= 1) global rows, that
// covers every row of the launch.
int nnueehcs_fused_mc_dropout_f32(const float* x, long long B, int d,
                                  const float* w_all, const float* b_all,
                                  int L, const int* relu, const int* thresh,
                                  const float* scale, const int* key, int S,
                                  uint32_t seed, uint32_t row_base,
                                  const uint32_t* seeds,
                                  uint32_t rows_per_seed, int out_dim,
                                  float* mean, float* std, void* stream) {
  const size_t smem = smem_bytes(out_dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mc_dropout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  fused_mc_dropout_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, B, d, w_all, b_all, L, relu, thresh, scale, key, S, seed, row_base,
      seeds, rows_per_seed, out_dim, mean, std);
  return static_cast<int>(cudaGetLastError());
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
