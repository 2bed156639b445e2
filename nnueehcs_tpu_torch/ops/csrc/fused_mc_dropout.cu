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
// same masks. A value is kept when the top 24 bits of its hash are below
// keep * 2^24.
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
// What bounds it: operations, at the dense bf16 tensor-core peak (989
// TFLOP/s on an H100 SXM); its tile is fused_chain_bf16.cuh's.
#include "fused_chain.cuh"
#include "fused_chain_bf16.cuh"

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

// Multiplies a value by its keep mask (scale or 0) for one Dropout in one
// sample; the identity when inactive (pass 0, or no Dropout).
struct DropMask {
  bool active;
  uint32_t stream;  // lowbias32(lowbias32(seed + sample*A) + key*B)
  uint32_t row0;    // global row of the tile's first row
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

// w_all: layer 0 as (d, 128), then layers 1..L-1 as (128, 128); b_all:
// (L, 128). relu[l] != 0: ReLU after layer l. thresh[l] >= 0: a Dropout
// with that keep threshold, scale[l] = 1/keep and module index key[l]
// comes before Linear l.
__global__ void __launch_bounds__(kThreads, 2)
    fused_mc_dropout_kernel(const float* __restrict__ x, long long B, int d,
                            const float* __restrict__ w_all,
                            const float* __restrict__ b_all, int L,
                            const int* __restrict__ relu,
                            const int* __restrict__ thresh,
                            const float* __restrict__ scale,
                            const int* __restrict__ key, int S, uint32_t seed,
                            int out_dim, float* __restrict__ mean,
                            float* __restrict__ std) {
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
  const float* w_hidden = w_all + static_cast<size_t>(d) * kWidth;
  const Identity none;

  for (int p = 0; p <= S; ++p) {
    // the mask before Linear l in this pass
    const auto mask_for = [&](int l) {
      DropMask m;
      const int t = __ldg(thresh + l);
      m.active = p > 0 && t >= 0;
      m.threshold = static_cast<uint32_t>(t);
      m.scale = __ldg(scale + l);
      m.row0 = static_cast<uint32_t>(row0);
      m.stream = lowbias32(
          lowbias32(seed + static_cast<uint32_t>(p - 1) * 0x9E3779B9u) +
          static_cast<uint32_t>(__ldg(key + l)) * 0x85EBCA6Bu);
      return m;
    };
    __syncthreads();  // the previous pass's last layer may still read act0
    float* in = act0;
    float* out = act1;
    for (int l = 0; l + 1 < L; ++l) {
      const float* b = b_all + static_cast<size_t>(l) * kWidth;
      const bool act = __ldg(relu + l) != 0;
      const DropMask next = mask_for(l + 1);
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

// The bf16 form: w_all as above in bf16, b_all fp32.
__global__ void __launch_bounds__(kThreads, 2)
    fused_mc_dropout_bf16_kernel(const float* __restrict__ x, long long B,
                                 int d,
                                 const __nv_bfloat16* __restrict__ w_all,
                                 const float* __restrict__ b_all, int L,
                                 const int* __restrict__ relu,
                                 const int* __restrict__ thresh,
                                 const float* __restrict__ scale,
                                 const int* __restrict__ key, int S,
                                 uint32_t seed, int out_dim,
                                 float* __restrict__ mean,
                                 float* __restrict__ std) {
  namespace fb = fused_chain_bf16;
  using bf16 = fb::bf16;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* act0 = reinterpret_cast<bf16*>(smem_bf16);
  bf16* act1 = act0 + kTileRows * fb::kAStride;
  bf16* sw = act1 + kTileRows * fb::kAStride;
  float* sc = reinterpret_cast<float*>(sw + 2 * kChunk * fb::kWStride);
  float* s1 = sc + kTileRows * out_dim;
  float* s2 = s1 + kTileRows * out_dim;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kTileRows), B - row0));
  const float* x_tile = x + row0 * d;
  const bf16* w_hidden = w_all + static_cast<size_t>(d) * kWidth;
  const Identity none;

  for (int p = 0; p <= S; ++p) {
    const auto mask_for = [&](int l) {
      DropMask m;
      const int t = __ldg(thresh + l);
      m.active = p > 0 && t >= 0;
      m.threshold = static_cast<uint32_t>(t);
      m.scale = __ldg(scale + l);
      m.row0 = static_cast<uint32_t>(row0);
      m.stream = lowbias32(
          lowbias32(seed + static_cast<uint32_t>(p - 1) * 0x9E3779B9u) +
          static_cast<uint32_t>(__ldg(key + l)) * 0x85EBCA6Bu);
      return m;
    };
    __syncthreads();  // the previous pass's last layer may still read act0
    bf16* in = act0;
    bf16* out = act1;
    for (int l = 0; l + 1 < L; ++l) {
      const float* b = b_all + static_cast<size_t>(l) * kWidth;
      const bool act = __ldg(relu + l) != 0;
      const DropMask next = mask_for(l + 1);
      if (l == 0) {
        fb::dense_layer<true>(in, out, sw, w_all, b, d, act, x_tile, d, valid,
                              mask_for(0), next);
      } else {
        fb::dense_layer<false>(
            in, out, sw, w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth,
            b, kWidth, act, nullptr, 0, valid, none, next);
      }
      bf16* t = in;
      in = out;
      out = t;
    }
    __syncthreads();  // the last epilogue's stores must land before the reads
    const int l = L - 1;
    const float* b = b_all + static_cast<size_t>(l) * kWidth;
    const bool act = __ldg(relu + l) != 0;
    if (l == 0) {  // one Linear: x masked and rounded as it is read
      fb::last_layer_stats(fb::XLoad<DropMask>{x_tile, d, mask_for(0)}, valid,
                           w_all, b, d, act, out_dim, p == 0, sc, s1, s2);
    } else {
      fb::last_layer_stats(
          fb::ActLoad{in}, valid,
          w_hidden + static_cast<size_t>(l - 1) * kWidth * kWidth, b, kWidth,
          act, out_dim, p == 0, sc, s1, s2);
    }
  }
  __syncthreads();  // the slots' owners are not write_stats' threads
  write_stats(sc, s1, s2, S, valid, row0, out_dim, mean, std);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks d >= 1, 1 <= out_dim <= 128, every hidden width <= 128 (zero-padded
// to 128 in w_all/b_all), L >= 1, S >= 1, B >= 1, fp32 contiguous device
// buffers, relu/thresh/key as L int32 and scale as L float32 values on the
// device, and allocates mean/std as (B, out_dim).
int nnueehcs_fused_mc_dropout_f32(const float* x, long long B, int d,
                                  const float* w_all, const float* b_all,
                                  int L, const int* relu, const int* thresh,
                                  const float* scale, const int* key, int S,
                                  uint32_t seed, int out_dim, float* mean,
                                  float* std, void* stream) {
  const size_t smem = smem_bytes(out_dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mc_dropout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  fused_mc_dropout_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, B, d, w_all, b_all, L, relu, thresh, scale, key, S, seed, out_dim,
      mean, std);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form; as nnueehcs_fused_mc_dropout_f32 with w_all in bf16.
int nnueehcs_fused_mc_dropout_bf16(const float* x, long long B, int d,
                                   const __nv_bfloat16* w_all,
                                   const float* b_all, int L, const int* relu,
                                   const int* thresh, const float* scale,
                                   const int* key, int S, uint32_t seed,
                                   int out_dim, float* mean, float* std,
                                   void* stream) {
  const size_t smem = fused_chain_bf16::smem_bytes(out_dim);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mc_dropout_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  fused_mc_dropout_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                 smem, static_cast<cudaStream_t>(stream)>>>(
      x, B, d, w_all, b_all, L, relu, thresh, scale, key, S, seed, out_dim,
      mean, std);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
