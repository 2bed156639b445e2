// Phase stamps, for a build with -DNNUEEHCS_STAMPS (ops/_build.py
// stamped_library; tools/train_step_phases.py, tools/eval_chain_phases.py).
// Thread 0 of one block (block 0 unless the unit's STAMPS_BLOCK entry names
// another) splits its time into phases by the SM clock
// (clock64): STAMP_BEGIN(on, id) starts a stamped span of the launch when
// `on` holds and opens phase `id`; STAMP(id) closes the open phase, adds
// its cycles to slot `open` of the translation unit's g_stamps, and opens
// phase `id`; STAMP_END() closes the last phase and adds the span's wall
// time (%globaltimer, ns) to slot kSlots. Slots accumulate over launches
// until the file's reader (STAMPS_READER) copies and clears them; the
// cycles of all slots over the wall time give the clock that converts
// them. What the thread waits for at a barrier is counted in the phase the
// barrier sits in. The state lives in 24 bytes of static shared memory and
// the sums are added by fire-and-forget atomics, so a stamp costs the
// thread a few instructions. Without the define every STAMP* is empty and
// the kernels compile as if the stamps were not there.
#pragma once

#ifdef NNUEEHCS_STAMPS

#include <cuda_runtime.h>

namespace stamps {

constexpr int kSlots = 1024;
// [0, kSlots) cycles per phase, then the stamped spans' wall time (ns)
constexpr int kWords = kSlots + 1;
constexpr unsigned long long kOff = ~0ull;   // no stamped span open

__device__ unsigned long long g_stamps[kWords];
__device__ int g_block;   // the stamped block

__device__ __forceinline__ unsigned long long* state() {
  // the open phase (kOff outside a span), its clock at opening, the span's
  // first timer reading
  __shared__ unsigned long long s[3];
  return s;
}

__device__ __forceinline__ bool stamper() {
  return static_cast<int>(blockIdx.x) == g_block && threadIdx.x == 0;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void begin(bool on, int id) {
  if (!stamper()) return;
  unsigned long long* s = state();
  s[0] = on && id >= 0 && id < kSlots ? static_cast<unsigned long long>(id)
                                      : kOff;
  if (s[0] == kOff) return;
  s[2] = globaltimer();
  s[1] = clock64();
}

__device__ __forceinline__ void phase(int id) {
  if (!stamper()) return;
  unsigned long long* s = state();
  if (s[0] == kOff || id < 0 || id >= kSlots) return;
  const unsigned long long t = clock64();
  atomicAdd(&g_stamps[s[0]], t - s[1]);
  s[1] = t;
  s[0] = static_cast<unsigned long long>(id);
}

__device__ __forceinline__ void end() {
  if (!stamper()) return;
  unsigned long long* s = state();
  if (s[0] == kOff) return;
  atomicAdd(&g_stamps[s[0]], clock64() - s[1]);
  atomicAdd(&g_stamps[kSlots], globaltimer() - s[2]);
  s[0] = kOff;
}

// Copies the kWords words into `out` and clears them.
inline int read(unsigned long long* out) {
  void* at = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, g_stamps);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(g_stamps));
  return static_cast<int>(err);
}

// Stamp block `block` from the next launch on.
inline int set_block(int block) {
  return static_cast<int>(cudaMemcpyToSymbol(g_block, &block, sizeof(int)));
}

}  // namespace stamps

#define STAMP_BEGIN(on, id) stamps::begin((on), (id))
#define STAMP(id) stamps::phase(id)
#define STAMP_END() stamps::end()
// the translation unit's reader, extern "C" int nnueehcs_stamps_<unit>(out),
// and its choice of block, extern "C" int nnueehcs_stamps_block_<unit>(b)
#define STAMPS_READER(unit)                                          \
  extern "C" int nnueehcs_stamps_##unit(unsigned long long* out) {   \
    return stamps::read(out);                                        \
  }                                                                  \
  extern "C" int nnueehcs_stamps_block_##unit(int block) {           \
    return stamps::set_block(block);                                 \
  }

#else

#define STAMP_BEGIN(on, id) ((void)0)
#define STAMP(id) ((void)0)
#define STAMP_END() ((void)0)
#define STAMPS_READER(unit)

#endif
