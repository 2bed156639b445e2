// Attribution probe of the fused training epoch (kernel 3) for Hopper
// (sm_90a), fp32: kernel 3 with parts of a step carved off, to split its
// time on the card.
//
// Replaces: experiments/grid_r5/attrib_train.py::ablate_epoch (the Pallas
// TPU probe, body ablate_epoch_kernel). Same function: S steps of the
// joint-mean loss sweep, member step and optimizer, without dropout, with
// `mode` carving off:
//   prod    nothing (the control: kernel 3's own three launches a step)
//   no_opt  the optimizer: the sweep and the member step, the loss written
//           by member 0's rank 0; theta, m and v stay as given
//   no_bwd  the backward too: the sweep, then one cluster for the loss, no
//           backward and no sums of g^2
//   fwd1    all but member 0's cluster forward (with its BatchNorm EMA) and
//           the loss of member 0's output, one cluster a step
//   empty   everything: one launch a step writes losses[s] = xs[s, 0, 0]
// and three fix candidates that leave the function as it is:
//   gn_fused   each block's sum of g^2 taken as its backward writes its
//              gradient values, not by cluster_reduce's re-read of the slab
//              (another summation order)
//   opt_chunk  adam_kernel's grid: one block per `chunk` elements, instead
//              of kernel 3's at most 1,024 blocks
//   unroll K   K steps' launches captured once as a CUDA graph, replayed
//              S/K times; the step index comes from device memory, which a
//              last node of the graph advances by K
// With `norms` (prod and no_opt), the last cluster of each step to hand on
// its member's sum of g^2 writes the step's global gradient norm, the
// clip's input, as the optimizer forms it from the members' partial sums;
// the gates read it.
//
// What bounds it on an H100: as kernel 3 (operations; see fused_train.cu):
// this probe exists to show where the time of a step goes instead.
//
// The design: every variant runs kernel 3's device code, the cluster form of
// fused_train_cluster.cuh (one thread-block cluster of kC blocks a member,
// the launch layout of ops/fused_train.py train_layout, both residency
// forms). prod, and prod with opt_chunk (another grid for the same
// optimizer kernel), launch kernel 3's own kernels; every other variant
// launches the forms of the same kernels that StepPart names (kStepProbe,
// kStepSqFused, kStepLoss: compile-time flags of the step kernel), which
// read the step index as *step_base + u when step_base is set.
#include "fused_train_cluster.cuh"

namespace {

enum { kProd = 0, kNoOpt = 1, kNoBwd = 2, kFwd1 = 3, kEmpty = 4 };

// empty: the launch floor, one thread.
__global__ void empty_kernel(Args A, int u) {
  const int step = step_index<true>(A, u);
  A.losses[step] = A.xs[static_cast<long long>(step) * A.i[kB] * A.i[kInPad]];
}

__global__ void advance_kernel(int* step_base, int k) { *step_base += k; }

struct Variant {
  int mode;
  bool sq_fused;
  long long chunk;   // optimizer elements per block, 0: kernel 3's grid
  bool own;          // kernel 3's own kernels (prod, no graph, no norms)
};

// The kernels of one residency form.
template <bool kRes>
struct Forms {
  static constexpr auto sweep = cluster_sweep_kernel<false, kRes>;
  static constexpr auto step = cluster_step_kernel<false, kRes>;
  static constexpr auto sweep_probe =
      cluster_sweep_kernel<false, kRes, kStepProbe>;
  static constexpr auto step_probe =
      cluster_step_kernel<false, kRes, kStepProbe>;
  static constexpr auto step_sq =
      cluster_step_kernel<false, kRes, kStepSqFused>;
  static constexpr auto step_loss =
      cluster_step_kernel<false, kRes, kStepLoss>;

  static cudaError_t prepare(const Layout& lay) {
    void (*const kernels[])(Args, Layout, int) = {
        sweep, step, sweep_probe, step_probe, step_sq, step_loss};
    for (auto kernel : kernels) {
      const cudaError_t err = prepare_kernel(kernel, lay);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }

  // Enqueue step u's launches (A.step_base: see step_index).
  static cudaError_t enqueue(const Args& A, const Layout& lay,
                             const Variant& V, int u, cudaStream_t st) {
    if (V.mode == kEmpty) {
      empty_kernel<<<1, 1, 0, st>>>(A, u);
      return cudaGetLastError();
    }
    if (V.mode == kFwd1) {   // member 0's own forward and loss
      Args own = A;
      own.i[kSingleSweep] = 1;
      return launch_cluster(step_loss, own, lay, u, st, 1);
    }
    cudaError_t err =
        launch_cluster(V.own ? sweep : sweep_probe, A, lay, u, st);
    if (err != cudaSuccess) return err;
    if (V.mode == kNoBwd) return launch_cluster(step_loss, A, lay, u, st, 1);
    err = launch_cluster(V.own ? step : V.sq_fused ? step_sq : step_probe, A,
                         lay, u, st);
    if (err != cudaSuccess || V.mode == kNoOpt) return err;
    const long long n = A.i[kM] * A.i[kSlabRows] * kLanes;
    const unsigned blocks = V.chunk == 0
        ? adam_blocks(n)
        : static_cast<unsigned>((n + V.chunk - 1) / V.chunk);
    if (V.own)
      adam_kernel<<<blocks, kOptThreads, 0, st>>>(A, u);
    else
      adam_kernel<true><<<blocks, kOptThreads, 0, st>>>(A, u);
    return cudaGetLastError();
  }

  // Capture `unroll` steps once and replay the graph S/unroll times on st;
  // A.step_base advances by unroll at the end of each replay.
  static cudaError_t graph(const Args& A, const Layout& lay, const Variant& V,
                           int unroll, cudaStream_t st) {
    cudaStream_t cap;
    cudaError_t err = cudaStreamCreateWithFlags(&cap, cudaStreamNonBlocking);
    if (err != cudaSuccess) return err;
    cudaGraph_t g = nullptr;
    err = cudaStreamBeginCapture(cap, cudaStreamCaptureModeThreadLocal);
    if (err == cudaSuccess) {
      cudaError_t launched = cudaSuccess;
      for (int u = 0; u < unroll && launched == cudaSuccess; ++u)
        launched = enqueue(A, lay, V, u, cap);
      if (launched == cudaSuccess) {
        advance_kernel<<<1, 1, 0, cap>>>(const_cast<int*>(A.step_base),
                                         unroll);
        launched = cudaGetLastError();
      }
      err = cudaStreamEndCapture(cap, &g);
      if (launched != cudaSuccess) err = launched;
    }
    cudaGraphExec_t exec = nullptr;
    if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
    for (long long r = 0; err == cudaSuccess && r < A.i[kS] / unroll; ++r)
      err = cudaGraphLaunch(exec, st);
    // an executable graph destroyed in flight is freed when it completes
    if (exec) cudaGraphExecDestroy(exec);
    if (g) cudaGraphDestroy(g);
    cudaStreamDestroy(cap);
    return err;
  }

  static int run(const Args& A, const Layout& lay, const Variant& V,
                 int unroll, cudaStream_t st) {
    cudaError_t err = prepare(lay);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (unroll > 1) return static_cast<int>(graph(A, lay, V, unroll, st));
    for (int u = 0; u < A.i[kS] && err == cudaSuccess; ++u)
      err = enqueue(A, lay, V, u, st);
    return static_cast<int>(err);
  }
};

}  // namespace

extern "C" {

// Run the S steps of one variant on `stream`; returns a cudaError_t (0 on
// success). Arguments as nnueehcs_fused_train_f32 (fused_train.cu), whose
// Python wrapper's checks apply (layout: train_layout of the plan, scratch
// M * its member_floats), with iconf's single_sweep 0 and n_drop 0 and every
// mask slot of lins -1 (the probe ignores dropout); then mode (prod, no_opt,
// no_bwd, fwd1, empty = 0..4), sq_fused (0/1), chunk (the optimizer's
// elements per block, 0 for kernel 3's grid), unroll (>= 1, dividing S),
// counters (two int32 on the device, both 0: the step index base of the
// unrolled graph and the count of clusters that have handed on a step's
// sums), norms (S floats on the device that receive each step's global
// gradient norm, prod and no_opt only; null for none) and signs (null, or
// kernel 3's (S, M, n_bn, B, 128) bytes of the backward's ReLU decisions;
// prod and no_opt only).
int nnueehcs_ablate_train_f32(const long long* iconf, const float* fconf,
                              const long long* layout, float* theta, float* m,
                              float* v, float* sigma, float* g,
                              const float* xs, const float* ys, float* losses,
                              const int* lins, const float* drops,
                              float* scratch, float* preds, float* small,
                              int mode, int sq_fused, long long chunk,
                              int unroll, int* counters, float* norms,
                              unsigned char* signs, void* stream) {
  Args A = make_args(iconf, fconf, theta, m, v, sigma, g, xs, ys, losses, lins,
                     drops, scratch, preds, small, signs);
  Layout lay;
  if (mode < kProd || mode > kEmpty || chunk < 0 || unroll < 1 ||
      ((norms || signs) && mode != kProd && mode != kNoOpt) ||
      A.i[kS] % unroll != 0 || A.i[kSingleSweep] != 0 ||
      !read_layout(A, layout, lay))
    return static_cast<int>(cudaErrorInvalidValue);
  if (unroll > 1) A.step_base = counters;
  A.norms = norms;
  A.norm_count = reinterpret_cast<unsigned*>(counters + 1);
  const Variant V{mode, sq_fused != 0, chunk,
                  mode == kProd && !sq_fused && !norms && unroll == 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lay.v[kLayResident] ? Forms<true>::run(A, lay, V, unroll, st)
                             : Forms<false>::run(A, lay, V, unroll, st);
}

}  // extern "C"
