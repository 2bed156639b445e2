// Fused whole-epoch training for Hopper (sm_90a), bf16-mixed: kernel 3's
// bf16 form.
//
// Replaces: nnueehcs_tpu/ops/fused_train.py::_epoch_kernel under
// FusedTrainPlan.bf16 (plan_fused_train(bf16=True), the JAX trainer's
// precision 'bf16-mixed'), whose mm() casts both operands of each of the
// three products of a block to bf16 and accumulates in fp32: the forward
// z = h W, the weight gradient dW = a^T d (contracting over the batch) and
// the input gradient d W^T. The gradient d is rounded at both backward
// products; dW and the propagated d come out fp32. Everything else (the
// master weights, BatchNorm and its EMA, the loss, the dropout masks, clip
// and Adam) is fp32 and is the fp32 form's code (fused_train.cuh).
//
// What bounds it on an H100: operations. A flagship step (8 members, 7 x 128
// MLP, batch 128) is 5.07e8 FLOP of products, 0.51 us at the 989 TFLOP/s
// dense bf16 tensor-core peak, plus the fp32 rest (BatchNorm, its backward,
// the optimizer); this first form is far from that bound, as the fp32 form
// is from its own.
//
// The design: the fp32 form's step (loss sweep, member step, optimizer; one
// block of 512 threads per member for the first two) with every block GEMM
// on the tensor cores (fused_train_bf16.cuh: operands rounded to bf16 as they
// are staged into shared memory, ldmatrix and mma.sync.m16n8k16 bf16 with
// fp32 accumulation). The fp32 form's kernels are not touched: its entry is
// fused_train.cu, and the probe's ablate_train.cu; both compile the same
// SASS as before this form existed, and this file compiles none of the
// fp32 step's kernels.
#define NNUEEHCS_NO_FP32_STEP
#include "fused_train_bf16.cuh"

extern "C" {

// Run S bf16-mixed training steps on `stream`; returns cudaGetLastError() (0
// on success). Arguments and buffers as nnueehcs_fused_train_f32
// (fused_train.cu): every buffer stays fp32.
int nnueehcs_fused_train_bf16(const long long* iconf, const float* fconf,
                              float* theta, float* m, float* v, float* sigma,
                              float* g, const float* xs, const float* ys,
                              float* losses, const int* lins,
                              const float* drops, float* scratch, float* preds,
                              float* small, unsigned char* signs,
                              void* stream) {
  const Args A = make_args(iconf, fconf, theta, m, v, sigma, g, xs, ys, losses,
                           lins, drops, scratch, preds, small, signs);
  return run_epoch<loss_sweep_bf16_kernel, member_step_bf16_kernel>(
      A, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
