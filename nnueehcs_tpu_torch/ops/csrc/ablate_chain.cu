// Attribution probes of the fused ensemble pass (kernel 1) for Hopper
// (sm_90a), fp32: kernel 1 with parts carved off or with other layouts of its
// input and outputs, to split its time on the card.
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
//   in bf16 (compute_dtype=bfloat16) as an instance of kernel 1b's body,
//   fused_chain_wgmma.cuh's ensemble_pass (the same cluster design, launch
//   layout and images, x read with its row stride).
// The outputs keep the TPU probes' padded widths, zeros past the chain's
// real width.
//
// What bounds them on an H100: operations (3xTF32 products on the tensor
// cores; bf16 ones for the packed bf16 form), except io_floor, which does
// none: bytes.
//
// The design. Every fp32 probe runs kernel 1's own body,
// fused_chain_wgmma.cuh's ensemble_tf32_as (3xTF32 wgmma products, the
// members over a cluster of min(M, 8) blocks folded in member order by the
// leader), one instance (ablate_tf32_kernel) for each mode, for a chain cut
// short, and for each layout of x and of the outputs that a probe asks for
// (x row-major or feature-major; outputs (B, ldo) rows, feature-major or
// packed, fw::OutLayout), with kernel 1's launch layout (eval_layout(
// 'ensemble', ..., fp32=True)) and images (chain_image of the fp32 weights;
// of the cut chain, every layer a hidden one): the math of every form but
// io_floor, gemm_only and no_epi is kernel 1's, bit for bit. narrow_forward
// is the prod instance with an x row stride and an output width of 8 or
// 128. `tile` only sets which row io_floor reads, as the TPU grid's block
// did.
#include "fused_chain_wgmma.cuh"

namespace {

namespace fw = fused_chain_wgmma;

// The packed probe in bf16: kernel 1b's body with the packed output.
template <bool kRing>
__global__ void __launch_bounds__(kRing ? fw::kWgThreads + 32 : 3 * fw::kWgThreads, 1)
    packed_bf16_kernel(const float* __restrict__ x, long long B, int d,
                       long long ldx, const unsigned char* __restrict__ images,
                       const float* __restrict__ b_all, int M, int L,
                       const int* __restrict__ relu, int out_dim,
                       float* __restrict__ out, fw::EnsembleLayout lay) {
  extern __shared__ __align__(128) unsigned char smem_wg[];
  fw::ensemble_pass<kRing, true>(smem_wg, x, B, d, ldx, images, b_all, M, L,
                                 relu, out_dim, out, nullptr, lay);
}

// The fp32 probes: kernel 1's body in the form kMode (fw::EnsembleForm), on
// the whole chain or (kCut) on one cut short, x row-major or (kXCols)
// feature-major, outputs in the layout kOut (fw::OutLayout) of width ldo.
template <int kMode, bool kCut, bool kXCols, int kOut>
__global__ void __launch_bounds__(2 * fw::kWgThreads, 1)
    ablate_tf32_kernel(const float* __restrict__ x, long long B, int d,
                       long long ldx, const unsigned char* __restrict__ images,
                       const float* __restrict__ b_all, int M, int m_all,
                       int L, const int* __restrict__ relu, int out_dim,
                       long long ldo, int tile, float* __restrict__ out0,
                       float* __restrict__ out1, fw::EnsembleLayout lay) {
  extern __shared__ __align__(128) unsigned char smem_tf[];
  fw::ensemble_tf32_as<kMode, kCut, kXCols, kOut>(
      smem_tf, x, B, d, ldx, images, b_all, M, m_all, L, relu, out_dim, ldo,
      tile, out0, out1, lay);
}

using Tf32Kernel = void (*)(const float*, long long, int, long long,
                            const unsigned char*, const float*, int, int, int,
                            const int*, int, long long, int, float*, float*,
                            fw::EnsembleLayout);

// The instance of a probe: mode (prod, io_floor, gemm_only, no_epi = 0..3)
// on a whole chain or one cut short (every mode but io_floor), x row-major,
// (B, ldo) outputs; or prod on the whole chain with a feature-major x and
// (B, ldo) or feature-major outputs (xt_forward), or with a row-major x and
// the packed output (packed_forward). Null for any other.
Tf32Kernel pick_tf32(int mode, int cut, int x_cols, int out) {
  if (!x_cols && out == fw::kOutRows) {
    switch (mode * 2 + (cut ? 1 : 0)) {
      case fw::kEnsProd * 2:
        return ablate_tf32_kernel<fw::kEnsProd, false, false, fw::kOutRows>;
      case fw::kEnsProd * 2 + 1:
        return ablate_tf32_kernel<fw::kEnsProd, true, false, fw::kOutRows>;
      case fw::kEnsIoFloor * 2:
        return ablate_tf32_kernel<fw::kEnsIoFloor, false, false, fw::kOutRows>;
      case fw::kEnsGemmOnly * 2:
        return ablate_tf32_kernel<fw::kEnsGemmOnly, false, false,
                                  fw::kOutRows>;
      case fw::kEnsGemmOnly * 2 + 1:
        return ablate_tf32_kernel<fw::kEnsGemmOnly, true, false,
                                  fw::kOutRows>;
      case fw::kEnsNoEpi * 2:
        return ablate_tf32_kernel<fw::kEnsNoEpi, false, false, fw::kOutRows>;
      case fw::kEnsNoEpi * 2 + 1:
        return ablate_tf32_kernel<fw::kEnsNoEpi, true, false, fw::kOutRows>;
      default: return nullptr;
    }
  }
  if (mode != fw::kEnsProd || cut) return nullptr;
  if (x_cols && out == fw::kOutRows)
    return ablate_tf32_kernel<fw::kEnsProd, false, true, fw::kOutRows>;
  if (x_cols && out == fw::kOutCols)
    return ablate_tf32_kernel<fw::kEnsProd, false, true, fw::kOutCols>;
  if (!x_cols && out == fw::kOutPacked)
    return ablate_tf32_kernel<fw::kEnsProd, false, false, fw::kOutPacked>;
  return nullptr;
}

}  // namespace

extern "C" {

// Launch an fp32 probe of kernel 1 on `stream`; returns a cudaError_t (0 on
// success). mode: prod, io_floor, gemm_only, no_epi (0..3); cut: 1 when L is
// fewer than the chain's layers; x_cols: 1 for a feature-major x; out:
// 1 (B, ldo) rows, 2 feature-major (ldo, B), 3 packed (B, 128) (pick_tf32's
// combinations). The caller checks: x (B, ldx) row-major, or (ldx, B)
// feature-major, with d real features, ldx >= d; images: the first M
// members' fp32 images of the chain's first L layers (chain_image; with cut,
// of every layer as a hidden one, open_end); b_all (L_all, m_all, 128) with
// 1 <= M <= m_all; relu the chain's int32 flags; out_dim the real width of
// layer L - 1 (128 when cut; <= 64 packed); ldo 8 or 128 rows (a multiple
// of 4), any width >= 1 feature-major, 128 packed; tile >= 1; out0 and out1
// (null for one output, and packed) fp32 contiguous device buffers; layout:
// eval_layout('ensemble', d, L, out_dim, B, sms, M, clusters, fp32=True)
// with the clusters nnueehcs_ablate_forward_f32_clusters reports.
int nnueehcs_ablate_forward_f32(int mode, int cut, int x_cols, int out,
                                const float* x, long long B, int d,
                                long long ldx, const unsigned char* images,
                                const float* b_all, int M, int m_all, int L,
                                const int* relu, int out_dim, long long ldo,
                                int tile, float* out0, float* out1,
                                const int* layout, void* stream) {
  const Tf32Kernel kernel = pick_tf32(mode, cut, x_cols, out);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  return static_cast<int>(fw::launch_cluster(
      kernel, lay, static_cast<cudaStream_t>(stream), x, B, d, ldx, images,
      b_all, M, m_all, L, relu, out_dim, ldo, tile, out0, out1, lay));
}

// The clusters of the probe instance (mode, cut, x_cols, out) at the layout
// `layout` that the card runs at once, or minus a cudaError_t.
int nnueehcs_ablate_forward_f32_clusters(int mode, int cut, int x_cols,
                                         int out, const int* layout) {
  const Tf32Kernel kernel = pick_tf32(mode, cut, x_cols, out);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return fw::max_clusters(kernel, fw::EnsembleLayout::from(layout));
}

// The packed probe in bf16, on `stream`; returns a cudaError_t. The caller
// checks: x (B, ldx) row-major with d real features, ldx >= d; images,
// b_all, relu and layout as nnueehcs_fused_ensemble_bf16's (the layout of
// this probe's own kernel: nnueehcs_packed_forward_bf16_clusters);
// out_dim <= 64; out a (B, 128) fp32 contiguous device buffer.
int nnueehcs_packed_forward_bf16(const float* x, long long B, int d,
                                 long long ldx, const unsigned char* images,
                                 const float* b_all, int M, int L,
                                 const int* relu, int out_dim, float* out,
                                 const int* layout, void* stream) {
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  const auto kernel =
      lay.base.ring ? packed_bf16_kernel<true> : packed_bf16_kernel<false>;
  return static_cast<int>(fw::launch_cluster(
      kernel, lay, static_cast<cudaStream_t>(stream), x, B, d, ldx, images,
      b_all, M, L, relu, out_dim, out, lay));
}

// As nnueehcs_fused_ensemble_bf16_clusters, for the probe's kernel.
int nnueehcs_packed_forward_bf16_clusters(const int* layout) {
  const fw::EnsembleLayout lay = fw::EnsembleLayout::from(layout);
  return lay.base.ring ? fw::max_clusters(packed_bf16_kernel<true>, lay)
                       : fw::max_clusters(packed_bf16_kernel<false>, lay);
}

}  // extern "C"
