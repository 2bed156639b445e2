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
// What bounds it on an H100: operations, and this first form is far from
// the bound. A flagship step (8 members, 7 x 128 MLP, batch 128) is one
// forward, the weight gradients and the input gradients: 5.1e8 fp32 FLOP,
// 7.6 us at 67 TFLOP/s. The TPU kernel recomputes each member's forward in
// its backward because VMEM cannot hold every member's activations; here
// the loss sweep saves them in a per-member scratch in device memory. The
// parameters and both moments (3.3 MB each at the flagship) stay resident
// in the 50 MB L2 for the whole epoch.
//
// The design, simple and right first:
// - one step is two or three launches on the caller's stream: a loss sweep
//   (joint mean only: one block per member runs its forward with the EMA,
//   saves what the backward needs and writes its prediction), the member
//   step (one block per member: in single-sweep mode the member's forward;
//   the joint loss and gradient from all members' predictions, or the
//   member's own; the backward into g; the member's sum of g^2), and the
//   optimizer (a grid over the flat buffers; every block adds the
//   members' partial sums in member order, so the clip scale is the same
//   everywhere and the run is deterministic: no float atomics);
// - a block of 512 threads keeps one member's activations in a per-member
//   scratch in device memory (L2-resident) and runs every product as a
//   block GEMM: 128-row tiles, both operands staged through shared memory
//   32 reduction steps at a time, each thread a 4-row x 8-column register
//   tile of true fp32 FMAs (no TF32);
// - column statistics (BatchNorm mean and variance, the BatchNorm backward
//   sums, bias gradients) are sums over the batch per column in a fixed
//   order;
// - elementwise steps round each product and sum where the plain version
//   does (__fmul_rn/__fadd_rn), so nvcc cannot contract them into FMAs;
//   sqrt and division are IEEE, expf/logf/log1pf the accurate ones.
// One block per member uses 8 of the 132 SMs at the flagship and one for a
// single net; spreading a member over a thread-block cluster is later work.
//
// The device code is in fused_train.cuh, shared with the attribution probe
// (ablate_train.cu); this file holds only the entry that drives an epoch.
#include "fused_train.cuh"

extern "C" {

// Floats of one member's scratch for batch B, n_bn BatchNorm slots and
// n_drop dropout slots; the caller allocates M of them.
long long nnueehcs_fused_train_scratch_floats(int B, int n_bn, int n_drop) {
  return scratch_floats(B, n_bn, n_drop);
}

// Run S training steps on `stream`; returns cudaGetLastError() (0 on
// success). iconf/fconf are host arrays in the order of the int and float
// enums of fused_train.cuh. The caller checks the shapes (theta/m/v/g:
// (M*slab_rows, 128); sigma: (M*sig_rows, 128); xs: (S, B, in_pad); ys:
// (S, B, out_pad); lins: (n_lins, 12) int32; drops: max(n_drop, 1);
// scratch: M * scratch_floats; preds: (M, B, 128); small: 2M floats),
// zeroes g, and keeps every buffer fp32, contiguous and on the device.
// `signs` is null, or (S, M, n_bn, B, 128) bytes that receive each ReLU
// decision of the backward (1 where the pre-ReLU value is > 0).
int nnueehcs_fused_train_f32(const long long* iconf, const float* fconf,
                             float* theta, float* m, float* v, float* sigma,
                             float* g, const float* xs, const float* ys,
                             float* losses, const int* lins, const float* drops,
                             float* scratch, float* preds, float* small,
                             unsigned char* signs, void* stream) {
  const Args A = make_args(iconf, fconf, theta, m, v, sigma, g, xs, ys, losses,
                           lins, drops, scratch, preds, small, signs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned M = static_cast<unsigned>(A.i[kM]);
  const unsigned blocks = adam_blocks(A.i[kM] * A.i[kSlabRows] * kLanes);
  for (int step = 0; step < A.i[kS]; ++step) {
    if (!A.i[kSingleSweep]) loss_sweep_kernel<<<M, kThreads, 0, st>>>(A, step);
    member_step_kernel<<<M, kThreads, 0, st>>>(A, step);
    adam_kernel<<<blocks, kOptThreads, 0, st>>>(A, step);
    if (step == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
