// Attribution probe of the fused training epoch (kernel 3) for Hopper
// (sm_90a), fp32: kernel 3 with parts of a step carved off, to split its
// time on the card.
//
// Replaces: experiments/grid_r5/attrib_train.py::ablate_epoch (the Pallas
// TPU probe, body ablate_epoch_kernel). Same function: S steps of the
// joint-mean loss sweep, member step and optimizer, without dropout, with
// `mode` carving off:
//   prod    nothing (the control: kernel 3's own three launches a step)
//   no_opt  the optimizer: the sweep and the member step, loss written by
//           member 0's block; theta, m and v stay as given
//   no_bwd  the backward too: the sweep, then one block for the loss
//   fwd1    all but member 0's forward (with its BatchNorm EMA) and the loss
//           of member 0's output, one block a step
//   empty   everything: one launch a step writes losses[s] = xs[s, 0, 0]
// and three fix candidates that leave the function as it is:
//   gn_fused   each member's sum of g^2 taken as its backward writes g, not
//              by re-reading its slab (another summation order)
//   opt_chunk  the optimizer's grid-stride loop over one block per `chunk`
//              rows of 128, instead of kernel 3's at most 1,024 blocks
//   unroll K   K steps' launches captured once as a CUDA graph, replayed
//              S/K times; the step index comes from device memory, which a
//              last node of the graph advances by K
// With `norms` (prod and no_opt), a one-thread launch after each member
// step writes the step's global gradient norm, the clip's input, as the
// optimizer forms it from the members' partial sums; the gates read it.
//
// What bounds it on an H100: as kernel 3 (operations; see fused_train.cu):
// this probe exists to show where the time of a step goes instead.
//
// The design: every variant runs the device code of fused_train.cuh. prod,
// and prod with opt_chunk (another grid for the same optimizer kernel),
// launch kernel 3's own kernels; every other variant launches a shell here
// around the same bodies (loss_sweep, member_step, adam_step,
// member_forward, loss_and_grad), which reads the step index as
// *step_base + u (step_base null: u itself).
#include "fused_train.cuh"

namespace {

enum { kProd = 0, kNoOpt = 1, kNoBwd = 2, kFwd1 = 3, kEmpty = 4 };

__device__ __forceinline__ int step_at(const int* step_base, int u) {
  return step_base ? *step_base + u : u;
}

__global__ void __launch_bounds__(kThreads, 1)
    sweep_k(Args A, const int* step_base, int u) {
  __shared__ __align__(16) Smem sm;
  loss_sweep(A, step_at(step_base, u), sm);
}

// The member step; with kLoss, member 0's block writes the step's loss
// (no_opt, where no optimizer launch does).
template <bool kSqFused, bool kLoss>
__global__ void __launch_bounds__(kThreads, 1)
    member_step_k(Args A, const int* step_base, int u) {
  __shared__ __align__(16) Smem sm;
  const int step = step_at(step_base, u);
  member_step<kSqFused>(A, step, sm);
  if (kLoss && blockIdx.x == 0 && threadIdx.x == 0)
    A.losses[step] = __fdiv_rn(A.terms[0], A.f[kLossDiv]);
}

__global__ void __launch_bounds__(kOptThreads)
    adam_k(Args A, const int* step_base, int u) {
  adam_step(A, step_at(step_base, u));
}

// no_bwd: the joint-mean loss of the sweep's predictions, one block.
__global__ void __launch_bounds__(kThreads, 1)
    loss_k(Args A, const int* step_base, int u) {
  __shared__ __align__(16) Smem sm;
  const int step = step_at(step_base, u);
  const float term = joint_loss(A, step, member_scratch(A, 0), sm);
  if (threadIdx.x == 0) A.losses[step] = __fdiv_rn(term, A.f[kLossDiv]);
}

// fwd1: member 0's forward with its EMA and the loss of its output.
__global__ void __launch_bounds__(kThreads, 1)
    fwd1_k(Args A, const int* step_base, int u) {
  __shared__ __align__(16) Smem sm;
  const int step = step_at(step_base, u);
  const Member s = member_scratch(A, 0);
  member_forward(A, step, 0, s, sm);
  const float term = loss_and_grad(A, step, s.h, s.d, sm);
  if (threadIdx.x == 0) A.losses[step] = __fdiv_rn(term, A.f[kLossDiv]);
}

// empty: the launch floor, one thread.
__global__ void empty_k(Args A, const int* step_base, int u) {
  const int step = step_at(step_base, u);
  A.losses[step] = A.xs[static_cast<long long>(step) * A.i[kB] * A.i[kInPad]];
}

__global__ void advance_k(int* step_base, int k) { *step_base += k; }

// The step's global gradient norm, as adam_step forms it: the members'
// partial sums added in member order.
__global__ void norm_k(Args A, const int* step_base, int u, float* norms) {
  float gn2 = 0.f;
  for (int j = 0; j < static_cast<int>(A.i[kM]); ++j)
    gn2 = __fadd_rn(gn2, A.partials[j]);
  norms[step_at(step_base, u)] = __fsqrt_rn(gn2);
}

struct Variant {
  int mode;
  bool sq_fused;
  long long chunk;   // optimizer elements per block, 0: kernel 3's grid
  float* norms;      // each step's global gradient norm, or null
};

// Enqueue step u's launches (the step index is *step_base + u when
// step_base is not null).
void enqueue_step(const Args& A, const Variant& V, const int* step_base,
                  int u, cudaStream_t st) {
  const unsigned M = static_cast<unsigned>(A.i[kM]);
  const long long n = A.i[kM] * A.i[kSlabRows] * kLanes;
  switch (V.mode) {
    case kEmpty:
      empty_k<<<1, 1, 0, st>>>(A, step_base, u);
      return;
    case kFwd1:
      fwd1_k<<<1, kThreads, 0, st>>>(A, step_base, u);
      return;
    case kNoBwd:
      sweep_k<<<M, kThreads, 0, st>>>(A, step_base, u);
      loss_k<<<1, kThreads, 0, st>>>(A, step_base, u);
      return;
    case kNoOpt:
      sweep_k<<<M, kThreads, 0, st>>>(A, step_base, u);
      if (V.sq_fused)
        member_step_k<true, true><<<M, kThreads, 0, st>>>(A, step_base, u);
      else
        member_step_k<false, true><<<M, kThreads, 0, st>>>(A, step_base, u);
      if (V.norms) norm_k<<<1, 1, 0, st>>>(A, step_base, u, V.norms);
      return;
    default:
      break;
  }
  const unsigned blocks = V.chunk == 0
      ? adam_blocks(n)
      : static_cast<unsigned>((n + V.chunk - 1) / V.chunk);
  if (!step_base && !V.sq_fused) {   // kernel 3's own kernels
    loss_sweep_kernel<<<M, kThreads, 0, st>>>(A, u);
    member_step_kernel<<<M, kThreads, 0, st>>>(A, u);
    if (V.norms) norm_k<<<1, 1, 0, st>>>(A, step_base, u, V.norms);
    adam_kernel<<<blocks, kOptThreads, 0, st>>>(A, u);
    return;
  }
  sweep_k<<<M, kThreads, 0, st>>>(A, step_base, u);
  if (V.sq_fused)
    member_step_k<true, false><<<M, kThreads, 0, st>>>(A, step_base, u);
  else
    member_step_k<false, false><<<M, kThreads, 0, st>>>(A, step_base, u);
  if (V.norms) norm_k<<<1, 1, 0, st>>>(A, step_base, u, V.norms);
  adam_k<<<blocks, kOptThreads, 0, st>>>(A, step_base, u);
}

// Capture `unroll` steps once and replay the graph S/unroll times on st.
cudaError_t run_graph(const Args& A, const Variant& V, int unroll,
                      int* step_base, cudaStream_t st) {
  cudaStream_t cap;
  cudaError_t err = cudaStreamCreateWithFlags(&cap, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  cudaGraph_t graph = nullptr;
  err = cudaStreamBeginCapture(cap, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    for (int u = 0; u < unroll; ++u) enqueue_step(A, V, step_base, u, cap);
    advance_k<<<1, 1, 0, cap>>>(step_base, unroll);
    err = cudaStreamEndCapture(cap, &graph);
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  for (long long r = 0; err == cudaSuccess && r < A.i[kS] / unroll; ++r)
    err = cudaGraphLaunch(exec, st);
  // an executable graph destroyed in flight is freed when it completes
  if (exec) cudaGraphExecDestroy(exec);
  if (graph) cudaGraphDestroy(graph);
  cudaStreamDestroy(cap);
  return err;
}

}  // namespace

extern "C" {

// Run the S steps of one variant on `stream`; returns a cudaError_t (0 on
// success). Arguments as nnueehcs_fused_train_f32 (fused_train.cu), whose
// Python wrapper's checks apply, with iconf's single_sweep 0 and n_drop 0
// and every mask slot of lins -1 (the probe ignores dropout); then mode
// (prod, no_opt, no_bwd, fwd1, empty = 0..4), sq_fused (0/1), chunk (the
// optimizer's elements per block, 0 for kernel 3's grid), unroll (>= 1,
// dividing S), step_base (one int32 on the device, 0, used when
// unroll > 1), norms (S floats on the device that receive each step's
// global gradient norm, prod and no_opt only; null for none) and signs
// (null, or kernel 3's (S, M, n_bn, B, 128) bytes of the backward's ReLU
// decisions; prod and no_opt only).
int nnueehcs_ablate_train_f32(const long long* iconf, const float* fconf,
                              float* theta, float* m, float* v, float* sigma,
                              float* g, const float* xs, const float* ys,
                              float* losses, const int* lins,
                              const float* drops, float* scratch, float* preds,
                              float* small, int mode, int sq_fused,
                              long long chunk, int unroll, int* step_base,
                              float* norms, unsigned char* signs,
                              void* stream) {
  const Args A = make_args(iconf, fconf, theta, m, v, sigma, g, xs, ys, losses,
                           lins, drops, scratch, preds, small, signs);
  const Variant V{mode, sq_fused != 0, chunk, norms};
  if (mode < kProd || mode > kEmpty || chunk < 0 || unroll < 1 ||
      ((norms || signs) && mode != kProd && mode != kNoOpt) ||
      A.i[kS] % unroll != 0 || A.i[kSingleSweep] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unroll > 1)
    return static_cast<int>(run_graph(A, V, unroll, step_base, st));
  for (int step = 0; step < A.i[kS]; ++step) {
    enqueue_step(A, V, nullptr, step, st);
    if (step == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
