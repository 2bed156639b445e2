// Attribution probes of the fused ensemble pass (kernel 1) for Hopper
// (sm_90a), fp32: kernel 1 with parts carved off or with other layouts of
// its input and outputs, to split its time on the card.
//
// Replaces four Pallas TPU probes, each a variant of _fused_kernel:
// - experiments/grid_r5/attrib_eval.py::ablate_forward (body ablate_kernel):
//   modes prod, io_floor (load x, write 1 + x[first row of the tile, 0]),
//   gemm_only (no bias, no ReLU) and no_epi (out0 = the last member's
//   output, out1 = member 0's), one or two outputs, members or layers cut;
// - experiments/grid_r5/attrib_eval.py::xt_forward (body xt_kernel): x fed
//   feature-major, (d_pad, B); mean and std (B, 128) or feature-major;
// - experiments/grid_r5/attrib_eval2.py::narrow_forward (body narrow_kernel):
//   an 8- or 128-column x, 8- or 128-column mean and std;
// - experiments/grid_r4/kernel_variants.py::packed_forward (body
//   packed_kernel): mean and std packed into one (B, 128) buffer, fp32, and
//   in bf16 (compute_dtype=bfloat16) as an instance of kernel 1's bf16 body,
//   fused_chain_bf16.cuh's ensemble_pass.
// The outputs keep the TPU probes' padded widths, zeros past the chain's
// real width.
//
// What bounds them on an H100: operations, as kernel 1 (fused_ensemble.cu),
// except io_floor, which does none: bytes.
//
// The design: each probe is an instance of kernel 1's own body,
// fused_chain.cuh's ensemble_pass, with compile-time flags for the mode,
// the number of outputs, the x layout and the output layout, so the probes'
// prod control is kernel 1's code and cannot drift from it. The CUDA block
// tile is fixed at 64 rows by the register tiling; `tile` only sets which
// row io_floor reads, as the TPU grid's block did.
#include "fused_chain.cuh"
#include "fused_chain_bf16.cuh"

using namespace fused_chain;

namespace {

template <int kMode, int kNOut, bool kXCols, int kOut>
__global__ void __launch_bounds__(kThreads, 2)
    ablate_chain_kernel(const float* __restrict__ x, long long B, int d,
                        long long ldx, const float* __restrict__ w_all,
                        const float* __restrict__ b_all, int M_all, int M,
                        int L, const int* __restrict__ relu, int out_dim,
                        int ow, int tile, float* __restrict__ out0,
                        float* __restrict__ out1) {
  extern __shared__ __align__(16) float smem[];
  ensemble_pass<kMode, kNOut, kXCols, kOut>(smem, x, B, d, ldx, w_all, b_all,
                                            M_all, M, L, relu, out_dim, ow,
                                            tile, out0, out1);
}

using Kernel = void (*)(const float*, long long, int, long long, const float*,
                        const float*, int, int, int, const int*, int, int, int,
                        float*, float*);

// The instances the Python wrappers use; null for any other combination.
Kernel pick(int mode, int n_out, int x_cols, int out) {
  if (!x_cols && out == kOutRows) {
    switch (mode * 2 + n_out - 1) {
      case kProd * 2: return ablate_chain_kernel<kProd, 1, false, kOutRows>;
      case kProd * 2 + 1: return ablate_chain_kernel<kProd, 2, false, kOutRows>;
      case kIoFloor * 2: return ablate_chain_kernel<kIoFloor, 1, false, kOutRows>;
      case kIoFloor * 2 + 1: return ablate_chain_kernel<kIoFloor, 2, false, kOutRows>;
      case kGemmOnly * 2: return ablate_chain_kernel<kGemmOnly, 1, false, kOutRows>;
      case kGemmOnly * 2 + 1: return ablate_chain_kernel<kGemmOnly, 2, false, kOutRows>;
      case kNoEpi * 2: return ablate_chain_kernel<kNoEpi, 1, false, kOutRows>;
      case kNoEpi * 2 + 1: return ablate_chain_kernel<kNoEpi, 2, false, kOutRows>;
      default: return nullptr;
    }
  }
  if (mode != kProd) return nullptr;
  if (x_cols && n_out == 2 && out == kOutRows)
    return ablate_chain_kernel<kProd, 2, true, kOutRows>;
  if (x_cols && n_out == 2 && out == kOutCols)
    return ablate_chain_kernel<kProd, 2, true, kOutCols>;
  if (!x_cols && n_out == 1 && out == kOutPacked)
    return ablate_chain_kernel<kProd, 1, false, kOutPacked>;
  return nullptr;
}

// The packed probe in bf16: kernel 1's bf16 body with the packed output.
__global__ void __launch_bounds__(kThreads, 2)
    packed_bf16_kernel(const float* __restrict__ x, long long B, int d,
                       long long ldx, const __nv_bfloat16* __restrict__ w_all,
                       const float* __restrict__ b_all, int M, int L,
                       const int* __restrict__ relu, int out_dim,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  fused_chain_bf16::ensemble_pass<kOutPacked>(smem_bf16, x, B, d, ldx, w_all,
                                              b_all, M, L, relu, out_dim, out,
                                              nullptr);
}

}  // namespace

extern "C" {

// Launch one probe on `stream`; returns a cudaError_t (0 on success).
// mode: prod, io_floor, gemm_only, no_epi (0..3); n_out: 1 or 2; x_cols: 1
// for a feature-major x; out_layout: 1 (B, ow) rows, 2 feature-major
// (ow, B), 3 packed (B, 128). The caller checks the shapes: x holds d real
// features (zeros past them), (B, ldx) row-major or (ldx, B) feature-major,
// ldx >= d; w_all/b_all/relu as nnueehcs_fused_ensemble_f32 for M_all
// members; 1 <= M <= M_all and 1 <= L <= the chain's layers; out_dim the
// real width of layer L-1 (<= 128; <= 64 packed); 1 <= ow <= 128 (128
// packed); tile >= 1; fp32 contiguous device buffers; out1 null when
// n_out is 1.
int nnueehcs_ablate_chain_f32(int mode, int n_out, int x_cols, int out_layout,
                              const float* x, long long B, int d,
                              long long ldx, const float* w_all,
                              const float* b_all, int M_all, int M, int L,
                              const int* relu, int out_dim, int ow, int tile,
                              float* out0, float* out1, void* stream) {
  const Kernel kernel = pick(mode, n_out, x_cols, out_layout);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(out_dim);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, B, d, ldx, w_all, b_all, M_all, M, L, relu, out_dim, ow, tile, out0,
      out1);
  return static_cast<int>(cudaGetLastError());
}

// The packed probe in bf16, on `stream`; returns a cudaError_t. The caller
// checks: x (B, ldx) row-major with d real features, ldx >= d; w_all as
// nnueehcs_fused_ensemble_bf16's (bf16), b_all and relu too; out_dim <= 64;
// out a (B, 128) fp32 contiguous device buffer.
int nnueehcs_packed_forward_bf16(const float* x, long long B, int d,
                                 long long ldx, const __nv_bfloat16* w_all,
                                 const float* b_all, int M, int L,
                                 const int* relu, int out_dim, float* out,
                                 void* stream) {
  const size_t smem = fused_chain_bf16::smem_bytes(out_dim);
  cudaError_t err = cudaFuncSetAttribute(
      packed_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kTileRows - 1) / kTileRows;
  packed_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, B, d, ldx, w_all, b_all, M, L, relu, out_dim, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
