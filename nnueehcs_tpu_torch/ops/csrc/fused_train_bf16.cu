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
// and Adam) is fp32 and is the fp32 form's code.
//
// What bounds it on an H100: operations. A flagship step (8 members, 7 x 128
// MLP, batch 128) is 5.07e8 FLOP of products, 0.51 us at the 989 TFLOP/s
// dense bf16 tensor-core peak, plus the fp32 rest (BatchNorm, its backward,
// the optimizer).
//
// The design: the fp32 form's (fused_train_cluster.cuh: one thread-block
// cluster per member, activations exchanged through distributed shared
// memory) with each block's three products on the tensor cores
// (mma.sync.m16n8k16 bf16 over the block's 128 x 128/c slice, operands
// rounded to bf16 as they are read from the fp32 buffers, fp32
// accumulation).
#include "fused_train_cluster.cuh"

extern "C" {

// Run S bf16-mixed training steps on `stream`; returns a cudaError_t (0 on
// success). Arguments and buffers as nnueehcs_fused_train_f32
// (fused_train.cu), `lr` and `stop` included: every buffer stays fp32.
int nnueehcs_fused_train_bf16(const long long* iconf, const float* fconf,
                              const long long* layout, float* theta, float* m,
                              float* v, float* sigma, float* g,
                              const float* xs, const float* ys, float* losses,
                              const int* lins, const float* drops,
                              float* scratch, float* preds, float* small,
                              unsigned char* signs, const float* lr,
                              const int* stop, void* stream) {
  Args A = make_args(iconf, fconf, theta, m, v, sigma, g, xs, ys, losses, lins,
                     drops, scratch, preds, small, signs);
  A.lr_dev = lr;
  A.stop = stop;
  return run_cluster_epoch<true>(A, layout, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

STAMPS_READER(fused_train_bf16)
