// Fused whole-epoch training for Hopper (sm_90a), fp32.
//
// Replaces: nnueehcs_tpu/ops/fused_train.py::_epoch_kernel (the Pallas TPU
// kernel, driven by fused_epoch). Same function, step for step: for each of
// the S pre-gathered batches, every member's training-mode forward
// (BatchNorm on batch statistics, normalised with the biased variance; the
// running-stat EMA takes the unbiased one), the joint-mean or per-member
// l1/mse loss or the MVE Gaussian NLL, a hand-written backward from the
// x-hat, 1/sigma and dropout masks that the forward saved, then clip by
// global norm, bias-corrected Adam, decayed weights and theta -= lr * u
// over the whole flat (rows, 128) buffers. Dropout masks are the TPU
// kernel's stateless lowbias32 hash of (epoch seed, step, member, slot,
// row, column), computed here in uint32.
//
// What bounds it on an H100: operations. A flagship step (8 members, 7 x 128
// MLP, batch 128) is one forward, the weight gradients and the input
// gradients: 5.1e8 fp32 FLOP, 7.6 us at 67 TFLOP/s. The parameters and both
// moments (3.3 MB each at the flagship) stay resident in the 50 MB L2 for
// the whole epoch.
//
// The design (fused_train_cluster.cuh): one thread-block cluster per
// member, each block owning a slice of every layer's lanes, activations
// exchanged through distributed shared memory, weight slices prefetched
// with cp.async; one step is two or three launches on the caller's stream
// (the joint-mean loss sweep, the member step, adam_kernel). The attribution
// probe of this kernel (ablate_train.cu) runs the same device code.
#include "fused_train_cluster.cuh"

extern "C" {

// Run S training steps on `stream`; returns a cudaError_t (0 on success).
// iconf/fconf are host arrays in the order of the int and float enums of
// fused_train.cuh, layout the host array of fused_train.py's
// LAYOUT_FIELDS (train_layout). The caller checks the shapes (theta/m/v/g:
// (M*slab_rows, 128); sigma: (M*sig_rows, 128); xs: (S, B, in_pad); ys:
// (S, B, out_pad); lins: (n_lins, 12) int32; drops: max(n_drop, 1);
// scratch: M * member_floats; preds: (M, B, 128); small: 2M floats),
// zeroes g, and keeps every buffer fp32, contiguous and on the device.
// `signs` is null, or (S, M, n_bn, B, 128) bytes that receive each ReLU
// decision of the backward (1 where the pre-ReLU value is > 0).
// `lr` is null (the learning rate is fconf's) or one device float that
// the optimizer reads at each step; `stop` is null or one device int:
// when it holds a nonzero value as the epoch's launches run, every launch
// returns at once and the epoch leaves every buffer as it found it (the
// trainer's whole-fit dispatch, which enqueues epochs past an early stop
// that only the device has seen).
int nnueehcs_fused_train_f32(const long long* iconf, const float* fconf,
                             const long long* layout, float* theta, float* m,
                             float* v, float* sigma, float* g, const float* xs,
                             const float* ys, float* losses, const int* lins,
                             const float* drops, float* scratch, float* preds,
                             float* small, unsigned char* signs,
                             const float* lr, const int* stop,
                             void* stream) {
  Args A = make_args(iconf, fconf, theta, m, v, sigma, g, xs, ys, losses, lins,
                     drops, scratch, preds, small, signs);
  A.lr_dev = lr;
  A.stop = stop;
  return run_cluster_epoch<false>(A, layout,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"

STAMPS_READER(fused_train)
