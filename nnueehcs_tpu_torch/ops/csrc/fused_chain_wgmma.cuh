// The bf16 eval kernels on Hopper's warpgroup products: the MC-dropout and
// anchored kernels (2b and 5b: one network's bf16 chain applied many times,
// 129 passes of MC dropout, 229 anchors, to each 64-row tile) and the
// ensemble (1b, and its packed probe 10b: M members' chains on each tile,
// one thread-block cluster of member blocks; its section below), then the
// fp32 kernels 1, 2 and 5 on 3xTF32 products (their section at the end). The
// function is the JAX package's compute_dtype=bfloat16: weights folded in
// fp32 and rounded to bf16, every input of a dot rounded to bf16 (x as it is
// read, each hidden activation after bias, ReLU and any dropout mask),
// products accumulated in fp32; biases, the last layer's output and the
// statistics in fp32.
//
// The design (ops/fused_eval_chain.py lays it out on the host):
// - Persistent blocks, at most one per SM. Each holds the chain's weights
//   in shared memory as the host packed them (the "image"): every layer cut
//   into blocks of at most 128 input rows, each block stored K-major in 8 x
//   8 core matrices, the layout a wgmma shared-memory descriptor reads
//   without swizzle (leading byte offset 128: the next 8 k; stride byte
//   offset 16 * rows: the next 8 columns). Bulk copies (cp.async.bulk)
//   bring the image in, completing on an mbarrier.
// - Resident form: the whole image is loaded once per block and stays for
//   every tile and pass; the warpgroups never wait for each other. Ring
//   form (a chain too deep or too wide to stay): the image streams block by
//   block through `ring` slots of 32 KB, filled by one producer warp in the
//   order the consumers use them (full and empty mbarriers per slot), and
//   all consumer warpgroups of the block step through it together.
// - Consumer warpgroups of 128 threads each own a 64-row tile and run all
//   its passes in order, so the statistics are summed in pass order, with
//   no atomics, the same bits every run. Hidden layers are wgmma.mma_async
//   m64n128k16 with A in registers: the previous layer's fp32 accumulator
//   goes through bias, ReLU and mask, is rounded to bf16 and packed, and its
//   register layout is the A operand's, so a pass keeps its activations in
//   registers. Layer 0 takes x from device memory, rounded to bf16 as it is
//   read, 16 features a step (zeros past d and past the tile's rows). The
//   last layer runs m64n8k16 products per group of 8 output columns; the
//   shifted sums sc, s1, s2 of each (row, column) slot live in the
//   warpgroup's part of shared memory, owned by one thread for every pass.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "stamps.cuh"

namespace fused_chain_wgmma {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;              // rows of a tile, a warpgroup's
constexpr int kWidth = 128;            // padded layer width
constexpr int kWgThreads = 128;        // threads of a warpgroup
constexpr int kKBlock = 128;           // input rows of an image block
constexpr int kSlotBytes = kKBlock * kWidth * 2;   // the largest block
constexpr int kStatBytes = 3 * kWgThreads * 16;    // sc, s1, s2 of a group

// The launch layout, as the host computes it (LAYOUT_FIELDS, same order).
struct Layout {
  int warpgroups;   // consumer warpgroups of a block
  int ring;         // 0: resident image; else the ring's slots
  int out_groups;   // groups of 8 output columns, ceil(out_dim / 8)
  int image_bytes;  // the packed chain
  int smem_stats;   // byte offset of the statistics
  int smem_bars;    // byte offset of the mbarriers
  int smem_bytes;   // dynamic shared memory of a block
  int grid;         // blocks
  int threads;      // threads of a block: warpgroups * 128, + 32 for a ring

  static Layout from(const int* v) {
    return Layout{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
  }
};

// ---------------------------------------------------------------------------
// Shared memory, barriers and bulk copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16) from device memory to shared memory,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Warpgroup products

// A shared-memory matrix descriptor without swizzle: start address, leading
// byte offset (K direction) and stride byte offset (M/N direction).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of r across this point
// (accumulators in flight, values that must be formed before a wait).
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}

// acc (64 x 128 fp32, the m64n128 accumulator layout) = (scale_d ? acc : 0)
// + a (64 x 16 bf16 from registers) x B (16 x 128 bf16, K-major in shared
// memory at desc_b).
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// acc = a x B, as wgmma_n128 with scale_d 0, the accumulator written
// only: its old values are dead before the product, so their registers
// may hold other values until it is issued.
__device__ __forceinline__ void wgmma_n128_first(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 z;\nmov.b32 z, 0;\nsetp.ne.b32 p, z, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d (64 x 8 fp32) = (scale_d ? d : 0) + a (64 x 16 bf16, registers) x B
// (16 x 8 bf16, K-major in shared memory at desc_b).
__device__ __forceinline__ void wgmma_n8(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d = a x B, as wgmma_n8 with scale_d 0, d written only.
__device__ __forceinline__ void wgmma_n8_first(float& d0, float& d1,
                                               float& d2, float& d3,
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 z;\nmov.b32 z, 0;\nsetp.ne.b32 p, z, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---------------------------------------------------------------------------
// The chain's image: layer 0's d features rounded up to d16 (a multiple of
// 16) rows, cut into blocks [0, nb0) of 128 rows (the last one shorter);
// then one 128-row block for each later layer. Blocks are 128 columns
// wide, but the last layer's, which is out_n (out_groups * 8) wide. A
// block of R rows and N columns holds element (k, n) at byte
// ((n / 8) * (R / 8) + k / 8) * 128 + (n % 8) * 16 + (k % 8) * 2.
struct Chain {
  int d16, L, out_n, nb0;

  __device__ __forceinline__ Chain(int d, int layers, int out_groups)
      : d16((d + 15) & ~15),
        L(layers),
        out_n(8 * out_groups),
        nb0((((d + 15) & ~15) + kKBlock - 1) / kKBlock) {}

  // blocks of one pass through the chain
  __device__ __forceinline__ int blocks() const { return nb0 + L - 1; }
  __device__ __forceinline__ int cols0() const {
    return L == 1 ? out_n : kWidth;
  }
  __device__ __forceinline__ int rows(int b) const {
    return b < nb0 ? min(kKBlock, d16 - b * kKBlock) : kKBlock;
  }
  __device__ __forceinline__ int cols(int b) const {
    return b < nb0 ? cols0() : (b - nb0 + 2 == L ? out_n : kWidth);
  }
  __device__ __forceinline__ uint32_t offset(int b) const {
    return b < nb0 ? 2u * b * kKBlock * cols0()
                   : 2u * d16 * kWidth + (b - nb0) * kSlotBytes;
  }
  __device__ __forceinline__ uint32_t bytes(int b) const {
    return 2u * rows(b) * cols(b);
  }
};

// The weights in shared memory: the resident image (kRing false), or the
// ring's slots (full and empty barriers per slot; the consumers' warps each
// arrive on `empty` once they are done with a block). seq counts the blocks
// this thread has taken (or, for the producer, issued).
template <bool kRing>
struct Weights {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int slots;
  uint32_t seq;

  __device__ __forceinline__ Weights(unsigned char* smem, const Layout& lay)
      : base(smem),
        full(reinterpret_cast<uint64_t*>(smem + lay.smem_bars)),
        empty(reinterpret_cast<uint64_t*>(smem + lay.smem_bars) +
              (lay.ring > 0 ? lay.ring : 1)),
        slots(lay.ring),
        seq(0) {}

  // one thread, before the block's first barrier
  __device__ __forceinline__ void init(int warpgroups) {
    if (!kRing) {
      mbar_init(full, 1);
    } else {
      for (int s = 0; s < slots; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, 4 * warpgroups);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // resident form: one thread starts the copy of the whole image, or of
  // `count` images `stride` bytes apart in device memory, one after another
  __device__ __forceinline__ void load_image(const unsigned char* image,
                                             uint32_t bytes, int count = 1,
                                             long long stride = 0) {
    mbar_expect_tx(full, bytes * count);
    for (int i = 0; i < count; ++i)
      for (uint32_t off = 0; off < bytes; off += kSlotBytes)
        bulk_load(base + i * bytes + off, image + i * stride + off,
                  min(bytes - off, static_cast<uint32_t>(kSlotBytes)), full);
  }

  // the shared-memory address of block b, once it is there
  __device__ __forceinline__ uint32_t acquire(const Chain& c, int b) {
    STAMP(1);
    if (!kRing) return smem_u32(base) + c.offset(b);
    const uint32_t s = seq % slots;
    mbar_wait(full + s, (seq / slots) & 1);
    return smem_u32(base) + s * kSlotBytes;
  }

  // after the warp's products on the block have completed
  __device__ __forceinline__ void release(bool lane0) {
    if (!kRing) return;
    STAMP(10);
    __syncwarp();
    if (lane0) mbar_arrive(empty + seq % slots);
    ++seq;
  }

  // the producer: copy block b into the next slot once it is free
  __device__ __forceinline__ void produce(const Chain& c,
                                          const unsigned char* image, int b) {
    const uint32_t s = seq % slots, n = seq / slots;
    if (n > 0) mbar_wait(empty + s, (n - 1) & 1);
    const uint32_t bytes = c.bytes(b);
    mbar_expect_tx(full + s, bytes);
    bulk_load(base + s * kSlotBytes, image + c.offset(b), bytes, full + s);
    ++seq;
  }
};

// A consumer thread's place: warp w of its warpgroup holds tile rows r0 =
// 16 w + lane / 4 and r0 + 8; q = lane % 4 picks its columns (8 i + 2 q,
// + 1 of every group of 8 in the accumulators, 2 q, + 1, + 8, + 9 of every
// 16-feature step in A).
struct Thread {
  int lt, r0, q;
  bool lane0;

  __device__ __forceinline__ explicit Thread(int tid)
      : lt(tid % kWgThreads),
        r0(16 * ((tid % kWgThreads) >> 5) + ((tid & 31) >> 2)),
        q(tid & 3),
        lane0((tid & 31) == 0) {}
};

// The A fragment of 16-feature step kk of the tile's rows of x (x_tile:
// the tile's first row, row stride ldx): value (row r, feature c) is
// f(h, c, x) for r = r0 + 8 h, rounded to bf16; zeros past `valid` rows
// and past d features.
template <class F>
__device__ __forceinline__ void x_fragment(const float* x_tile, int d,
                                           long long ldx, int valid, int kk,
                                           const Thread& t, const F& f,
                                           uint32_t (&a)[4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = t.r0 + 8 * h, c = 16 * kk + 8 * s + 2 * t.q;
      float v0 = 0.f, v1 = 0.f;
      if (r < valid) {
        const float* p = x_tile + r * ldx;
        if (c < d) v0 = f(h, c, __ldg(p + c));
        if (c + 1 < d) v1 = f(h, c + 1, __ldg(p + c + 1));
      }
      a[2 * s + h] = pack(v0, v1);
    }
  }
}

struct NoMask {
  __device__ __forceinline__ float operator()(int, int, float v) const {
    return v;
  }
};

// acc (m64n128) = x's tile (through f, rounded) x layer 0, its blocks
// [0, nb0) taken in turn, one 16-feature step a product; `last` runs
// after the last step is issued, while it is in flight.
template <class W, class F, class G>
__device__ __forceinline__ void layer0_from_x(float (&acc)[64], W& wts,
                                              const Chain& c,
                                              const float* x_tile, int d,
                                              long long ldx, int valid,
                                              const Thread& t, const F& f,
                                              const G& last) {
  for (int b = 0; b < c.nb0; ++b) {
    const uint32_t addr = wts.acquire(c, b);
    const int steps = c.rows(b) / 16;
    for (int kk = 0; kk < steps; ++kk) {
      STAMP(2);
      uint32_t a[4];
      x_fragment(x_tile, d, ldx, valid, b * (kKBlock / 16) + kk, t, f, a);
      STAMP(3);
      pin(a);
      wgmma_fence();
      if ((b | kk) == 0) {
        wgmma_n128_first(acc, a, desc(addr, 128, c.rows(b) * 16));
      } else {
        wgmma_n128(acc, a, desc(addr + kk * 256, 128, c.rows(b) * 16), 1);
      }
      wgmma_commit();
      if (b + 1 == c.nb0 && kk + 1 == steps) last();
      STAMP(5);
      wgmma_wait_all();
      pin(acc);
      pin(a);
    }
    wts.release(t.lane0);
  }
}

// acc (m64n128) = a x one 128-row, 128-column block at addr, issued;
// the caller waits.
__device__ __forceinline__ void issue_n128(float (&acc)[64],
                                           uint32_t (&a)[8][4],
                                           uint32_t addr) {
  STAMP(3);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pin(a[kk]);
  wgmma_fence();
  wgmma_n128_first(acc, a[0], desc(addr, 128, kKBlock * 16));
#pragma unroll
  for (int kk = 1; kk < 8; ++kk)
    wgmma_n128(acc, a[kk], desc(addr + kk * 256, 128, kKBlock * 16), 1);
  wgmma_commit();
}

// Wait for the warpgroup's products; the accumulator and the A operand
// (a) are this thread's again.
__device__ __forceinline__ void wait_acc(float (&acc)[64],
                                         uint32_t (&a)[8][4]) {
  STAMP(5);
  wgmma_wait_all();
  pin(acc);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pin(a[kk]);
}

// Where the keep bit of accumulator slot (i, h, e) (row r0 + 8 h, column
// 8 i + 2 q + e) lies: word i / 8, bit keep_bit(i, h, e). Each of the four
// bytes of a word gathers one (h, e) pair's bits, the first column group's
// highest.
__device__ __forceinline__ constexpr int keep_bit(int i, int h, int e) {
  return 8 * (2 * h + e) + 7 - (i & 7);
}

// The next layer's A from the accumulator: bias (fp32, 128), ReLU, with
// kMask the keep bits (keep_bit) times `scale`, rounded to bf16 and packed
// where the A operand wants it. kLateBias keeps the bias loads after the
// products' wait, where the accumulator's registers free up, not before it
// beside the operands in flight (for a kernel at a tight register cap).
template <bool kMask, bool kLateBias = false>
__device__ __forceinline__ void epilogue(const float (&acc)[64],
                                         const float* bias, bool relu,
                                         const uint32_t (&keep)[2],
                                         float scale, const Thread& t,
                                         uint32_t (&a)[8][4]) {
  STAMP(6);
  uint64_t at = reinterpret_cast<uint64_t>(bias + 2 * t.q);
  if (kLateBias) asm volatile("" : "+l"(at)::"memory");
  const float* bq = reinterpret_cast<const float*>(at);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bq + 8 * i));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 4 * i + 2 * h;
      float v0 = acc[j] + b.x, v1 = acc[j + 1] + b.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (kMask) {
        v0 *= (keep[i >> 3] >> keep_bit(i, h, 0)) & 1u ? scale : 0.f;
        v1 *= (keep[i >> 3] >> keep_bit(i, h, 1)) & 1u ? scale : 0.f;
      }
      a[i >> 1][2 * (i & 1) + h] = pack(v0, v1);
    }
  }
}

// The last layer, column group g: acc = a x columns [8 g, 8 g + 8) of the
// 128-row block at addr; waits. Its own 4-register accumulator: products
// into a part of the hidden layers' accumulator serialise every wgmma.
__device__ __forceinline__ void last_group(float (&acc)[4],
                                           uint32_t (&a)[8][4],
                                           uint32_t addr, int g) {
  STAMP(8);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pin(a[kk]);
  wgmma_fence();
  const uint32_t base = addr + g * kKBlock * 16;
  wgmma_n8_first(acc[0], acc[1], acc[2], acc[3], a[0],
                 desc(base, 128, kKBlock * 16));
#pragma unroll
  for (int kk = 1; kk < 8; ++kk)
    wgmma_n8(acc[0], acc[1], acc[2], acc[3], a[kk],
             desc(base + kk * 256, 128, kKBlock * 16), 1);
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pin(a[kk]);
}

// The last layer of a one-Linear chain, column group g, from x (through f):
// acc = x's tile x columns [8 g, 8 g + 8) of layer 0, its blocks taken in
// turn (the image streams layer 0 once per group); waits.
template <class W, class F>
__device__ __forceinline__ void last_group_from_x(float (&acc)[4],
                                                  W& wts,
                                                  const Chain& c,
                                                  const float* x_tile, int d,
                                                  long long ldx, int valid,
                                                  const Thread& t, int g,
                                                  const F& f) {
  for (int b = 0; b < c.nb0; ++b) {
    const uint32_t addr = wts.acquire(c, b);
    const int rows = c.rows(b), steps = rows / 16;
    for (int kk = 0; kk < steps; ++kk) {
      STAMP(2);
      uint32_t a[4];
      x_fragment(x_tile, d, ldx, valid, b * (kKBlock / 16) + kk, t, f, a);
      STAMP(8);
      pin(a);
      wgmma_fence();
      const uint32_t base = addr + g * rows * 16;
      if ((b | kk) == 0) {
        wgmma_n8_first(acc[0], acc[1], acc[2], acc[3], a,
                       desc(base, 128, rows * 16));
      } else {
        wgmma_n8(acc[0], acc[1], acc[2], acc[3], a,
                 desc(base + kk * 256, 128, rows * 16), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(a);
    }
    wts.release(t.lane0);
  }
}

// The last layer's outputs h of the thread's slots in column group g (slot
// e = 2 h' + e' at row r0 + 8 h', column 8 g + 2 q + e'): its accumulator
// plus the bias, through the ReLU when one follows.
__device__ __forceinline__ void last_values(const float (&acc)[4],
                                            const float* bias, bool relu,
                                            int g, const Thread& t,
                                            float (&v)[4]) {
  const float2 b =
      __ldg(reinterpret_cast<const float2*>(bias + 8 * g + 2 * t.q));
  v[0] = acc[0] + b.x;
  v[1] = acc[1] + b.y;
  v[2] = acc[2] + b.x;
  v[3] = acc[3] + b.y;
  if (relu) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], 0.f);
  }
}

// Fold one pass's (or member's) outputs v of the thread's slots in column
// group g into the shifted sums sc, s1 and s2, st[(3 g + k) * 128] (float4,
// one slot a lane). The first pass sets the shift sc = h and zeroes s1, s2;
// every later one adds h - sc and its square, in pass order.
__device__ __forceinline__ void stats_fold(const float (&v)[4], int g,
                                           bool first, float4* st) {
  float4* p = st + 3 * g * kWgThreads;
  if (first) {
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[kWgThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
    p[2 * kWgThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const float4 c = p[0];
    float4 s1 = p[kWgThreads], s2 = p[2 * kWgThreads];
    const float d0 = v[0] - c.x, d1 = v[1] - c.y, d2 = v[2] - c.z,
                d3 = v[3] - c.w;
    s1.x += d0;
    s1.y += d1;
    s1.z += d2;
    s1.w += d3;
    s2.x += d0 * d0;
    s2.y += d1 * d1;
    s2.z += d2 * d2;
    s2.w += d3 * d3;
    p[kWgThreads] = s1;
    p[2 * kWgThreads] = s2;
  }
}

// The shifted sums from the last layer's accumulator of column group g.
__device__ __forceinline__ void stats_update(const float (&acc)[4],
                                             const float* bias, bool relu,
                                             int g, const Thread& t,
                                             bool first, float4* st) {
  float v[4];
  last_values(acc, bias, relu, g, t, v);
  stats_fold(v, g, first, st);
}

// mean = c + s1/n and std = sqrt(max(s2 - n m1^2, 0) / max(n - 1, 1)),
// m1 = s1/n, of the thread's slots in the tile's valid rows, with n m1^2
// rounded before the subtraction (fused_chain::write_stats' arithmetic);
// element (row, column) of each output at row * ldo + column.
__device__ __forceinline__ void stats_write(const float4* st, int groups,
                                            int count, const Thread& t,
                                            int valid, long long row0,
                                            int out_dim, long long ldo,
                                            float* mean, float* std) {
  STAMP(9);
  const float n = static_cast<float>(count);
  const float dof = static_cast<float>(count > 1 ? count - 1 : 1);
  for (int g = 0; g < groups; ++g) {
    {
      const float4* p = st + 3 * g * kWgThreads;
      const float4 c4 = p[0], a4 = p[kWgThreads], b4 = p[2 * kWgThreads];
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      const float s1[4] = {a4.x, a4.y, a4.z, a4.w};
      const float s2[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = t.r0 + 8 * (e >> 1), col = 8 * g + 2 * t.q + (e & 1);
        if (r < valid && col < out_dim) {
          const float m1 = s1[e] / n;
          const float var =
              fmaxf(__fsub_rn(s2[e], __fmul_rn(__fmul_rn(n, m1), m1)), 0.f) /
              dof;
          const long long o = (row0 + r) * ldo + col;
          mean[o] = c[e] + m1;
          std[o] = sqrtf(var);
        }
      }
    }
  }
}

// The tiles of consumer warpgroup gw of `stride` (all blocks' warpgroups):
// tiles gw, gw + stride, ...; in the ring form every warpgroup takes
// `rounds` of them, past the last tile as a tile of no rows, so that all
// consume the ring's blocks alike. Tile counts are 32-bit (up to 2^37 rows).
struct Tiles {
  int count, stride, rounds, gw;

  __device__ __forceinline__ Tiles(long long B, const Layout& lay, int wg)
      : Tiles(B, lay, wg, static_cast<int>(gridDim.x),
              static_cast<int>(blockIdx.x)) {}
  // the same over `units` units of blocks that share their tiles (the
  // clusters of the ensemble kernel), this block in unit `unit`
  __device__ __forceinline__ Tiles(long long B, const Layout& lay, int wg,
                                   int units, int unit)
      : count(static_cast<int>((B + kRows - 1) / kRows)),
        stride(units * lay.warpgroups),
        rounds(0),
        gw(unit * lay.warpgroups + wg) {
    rounds = (count + stride - 1) / stride;
  }
  // the tile of round r, or -1 when this warpgroup is done
  template <bool kRing>
  __device__ __forceinline__ int tile(int r) const {
    if (r >= rounds) return -1;
    const int t = r * stride + gw;
    return kRing || t < count ? t : -1;
  }
  __device__ __forceinline__ int valid(int t, long long B) const {
    return t < count ? static_cast<int>(min(static_cast<long long>(kRows),
                                            B - static_cast<long long>(t) *
                                                    kRows))
                     : 0;
  }
};

// ---------------------------------------------------------------------------
// Kernel 1b (the ensemble) and its packed probe 10b: one thread-block
// cluster of c = min(M, 8) blocks walks the tiles of a unit, block r
// running members r, r + c, ... of every tile; their last-layer outputs meet
// in the leader block (rank 0) through distributed shared memory.

// The launch layout of the ensemble kernel: Layout, then the cluster's
// fields (ENSEMBLE_FIELDS of ops/fused_eval_chain.py, same order).
struct EnsembleLayout {
  Layout base;
  int cluster;        // blocks of a cluster, c = min(M, 8)
  int members;        // images a block holds resident, ceil(M / c)
  int slots;          // slots of each exchange ring
  int smem_exchange;  // byte offset of the exchange rings

  static EnsembleLayout from(const int* v) {
    return EnsembleLayout{Layout::from(v), v[9], v[10], v[11], v[12]};
  }
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address in block `rank`'s shared memory of the local address `local`.
__device__ __forceinline__ uint32_t map_to(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}

// Every thread of the cluster: the writes before it are seen by every
// thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// 16 bytes into a peer's shared memory at `remote`, completing 16 bytes of
// the transaction count of the peer's mbarrier at `remote_bar`.
__device__ __forceinline__ void st_async16(uint32_t remote,
                                           const float (&v)[4],
                                           uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(remote_bar)
      : "memory");
}

// Arrive on a peer's mbarrier (the default semantics, as CUTLASS's cluster
// barriers arrive: a release at cluster scope costs the leader a fence on
// every slot it frees).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   remote_bar)
               : "memory");
}

// The lanes of a quad (q = 0..3: columns 2 q, 2 q + 1 of a group) that
// hold real outputs when there are out_dim of them, and the bytes of an
// exchange slot: a column group of a tile from those lanes, 16 bytes each.
__host__ __device__ __forceinline__ constexpr int exchange_lanes(int out_dim) {
  return out_dim >= 8 ? 4 : (out_dim + 1) / 2;
}
__host__ __device__ __forceinline__ constexpr int exchange_slot_bytes(
    int out_dim) {
  return 32 * exchange_lanes(out_dim) * 16;
}

// A consumer warpgroup's exchange. Peer p >= 1 sends each of its members'
// outputs of the warpgroup's tile, one column group at a time (its n-th
// group in order), into ring p - 1 of `slots` slots in the leader's shared
// memory: the 4 fp32 slot values (last_values) of each thread whose lane
// of the quad holds real columns (q < lanes) as one 16-byte st.async, to
// the place the leader's thread of the same slots reads. full[p - 1][s] in
// the leader counts the bytes in (the leader's thread 0 arrives with the
// count it expects before the warpgroup waits); empty[s] in the peer counts
// the leader's four warps done with slot s (their lane 0 arrives from the
// leader).
struct Exchange {
  unsigned char* rings;   // the warpgroup's rings, [p - 1][slot]
  uint64_t* full;         // [p - 1][slot]
  uint64_t* empty;        // [slot]
  int slots, lanes, slot_bytes;

  static __device__ __forceinline__ uint64_t* bars(
      unsigned char* smem, const EnsembleLayout& lay) {
    return reinterpret_cast<uint64_t*>(smem + lay.base.smem_bars) +
           (lay.base.ring > 0 ? 2 * lay.base.ring : 1);
  }

  __device__ __forceinline__ Exchange(unsigned char* smem,
                                      const EnsembleLayout& lay, int wg,
                                      int out_dim)
      : slots(lay.slots),
        lanes(exchange_lanes(out_dim)),
        slot_bytes(exchange_slot_bytes(out_dim)) {
    const int peers = lay.cluster - 1;
    rings = smem + lay.smem_exchange + wg * peers * slots * slot_bytes;
    full = bars(smem, lay) + wg * peers * slots;
    empty = bars(smem, lay) + lay.base.warpgroups * peers * slots +
            wg * slots;
  }

  // one thread, before Weights::init (whose fence covers these)
  static __device__ __forceinline__ void init(unsigned char* smem,
                                              const EnsembleLayout& lay) {
    uint64_t* b = bars(smem, lay);
    const int n_full = lay.base.warpgroups * (lay.cluster - 1) * lay.slots;
    for (int i = 0; i < n_full; ++i) mbar_init(b + i, 1);
    for (int i = 0; i < lay.base.warpgroups * lay.slots; ++i)
      mbar_init(b + n_full + i, 4);
  }

  // peer `rank`: its n-th group v to the leader, once the slot is free
  __device__ __forceinline__ void send(int rank, uint32_t n,
                                       const float (&v)[4],
                                       const Thread& t) {
    STAMP(11);
    const uint32_t s = n % slots, use = n / slots;
    if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
    if (t.q >= lanes) return;
    const int i = (rank - 1) * slots + static_cast<int>(s);
    st_async16(map_to(smem_u32(rings + i * slot_bytes + at(t)), 0), v,
               map_to(smem_u32(full + i), 0));
  }

  // a sending thread's 16 bytes within a slot
  __device__ __forceinline__ int at(const Thread& t) const {
    return ((t.lt >> 2) * lanes + t.q) * 16;
  }

  // the leader: peer p's n-th group into v, once it is in
  __device__ __forceinline__ void read(int p, uint32_t n, const Thread& t,
                                       float (&v)[4]) {
    STAMP(12);
    const int i = (p - 1) * slots + static_cast<int>(n % slots);
    if (t.lt == 0) mbar_expect_tx(full + i, slot_bytes);
    mbar_wait(full + i, (n / slots) & 1);
    const float4 q =
        t.q < lanes
            ? *reinterpret_cast<const float4*>(rings + i * slot_bytes + at(t))
            : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }

  // the leader, lane 0 of each warp once the warp has read it: peer p's
  // slot of its n-th group back to the peer
  __device__ __forceinline__ void free_slot(int p, uint32_t n) {
    mbar_arrive_remote(map_to(smem_u32(empty + n % slots), p));
  }
};

// The leader (kernels 1 and 1b): round i's member j c + p of each peer p in
// 1..peers (the j-th of each peer's own members), in member order, folded
// into the shifted sums of every column group (stats_fold's arithmetic,
// the sums in registers); a warp gives the slots of a column group back
// together once it has read them. Peer p sent its n-th group as its
// member after member of each round, ceil((M - p) / c) a round.
__device__ __forceinline__ void fold_peers(Exchange& ex, float4* st,
                                           int groups, int peers, int M,
                                           int c, int i, int j,
                                           const Thread& t) {
  const auto seq = [&](int p, int g) {
    return (static_cast<uint32_t>(i) * ((M - p + c - 1) / c) + j) * groups +
           g;
  };
  for (int g = 0; g < groups; ++g) {
    float4* q = st + 3 * g * kWgThreads;
    const float4 c4 = q[0];
    float4 s1 = q[kWgThreads], s2 = q[2 * kWgThreads];
    for (int p = 1; p <= peers; ++p) {
      float v[4];
      ex.read(p, seq(p, g), t, v);
      STAMP(13);
      const float d0 = v[0] - c4.x, d1 = v[1] - c4.y, d2 = v[2] - c4.z,
                  d3 = v[3] - c4.w;
      s1.x += d0;
      s1.y += d1;
      s1.z += d2;
      s1.w += d3;
      s2.x += d0 * d0;
      s2.y += d1 * d1;
      s2.z += d2 * d2;
      s2.w += d3 * d3;
    }
    q[kWgThreads] = s1;
    q[2 * kWgThreads] = s2;
    __syncwarp();
    if (t.lane0)
      for (int p = 1; p <= peers; ++p) ex.free_slot(p, seq(p, g));
  }
}

// Kernel 1b's body (and, with kPacked, probe 10b's): the M members of the
// folded chain on x's d real features (element (row, feature) at
// x[row * ldx + feature]); images: member m's chain image (chain_image) at
// images + m * image_bytes; b_all (L, M, 128) fp32. Block r of a cluster
// holds its members' images resident (or streams them through its ring) and
// runs them in turn on every tile of its warpgroups, members r, r + c, ...;
// the leader folds its own member j c and then the peers' members j c + 1,
// ..., j c + c - 1, in member order (member 0 the shift), and writes mean
// and std: (B, out_dim) each into out0 and out1, or with kPacked one (B,
// 128) buffer out0, mean in columns [0, out_dim), std in [out_dim,
// 2 out_dim), zeros past.
template <bool kRing, bool kPacked>
__device__ __forceinline__ void ensemble_pass(
    unsigned char* smem, const float* __restrict__ x, long long B, int d,
    long long ldx, const unsigned char* __restrict__ images,
    const float* __restrict__ b_all, int M, int L,
    const int* __restrict__ relu, int out_dim, float* __restrict__ out0,
    float* __restrict__ out1, const EnsembleLayout& lay) {
  const Layout& base = lay.base;
  const int c = lay.cluster;
  const int rank = static_cast<int>(cluster_rank());
  const int own = (M - rank + c - 1) / c;   // members rank, rank + c, ...
  const long long image_bytes = base.image_bytes;
  const Chain chain(d, L, base.out_groups);
  Weights<kRing> wts(smem, base);
  const int wg = threadIdx.x / kWgThreads;
  if (threadIdx.x == 0) {
    Exchange::init(smem, lay);
    wts.init(base.warpgroups);
  }
  cluster_sync();   // every block's barriers are set before a peer's use
  const Tiles tiles(B, base, wg, static_cast<int>(gridDim.x) / c,
                    static_cast<int>(blockIdx.x) / c);
  if (kRing && wg == base.warpgroups) {   // the ring's producer warp
    if (threadIdx.x % 32 == 0)
      for (int r = 0; r < tiles.rounds; ++r)
        for (int j = 0; j < own; ++j) {
          const unsigned char* image = images + (rank + j * c) * image_bytes;
          if (L == 1) {   // layer 0 once for each column group
            for (int g = 0; g < base.out_groups; ++g)
              for (int b = 0; b < chain.nb0; ++b) wts.produce(chain, image, b);
          } else {
            for (int b = 0; b < chain.blocks(); ++b)
              wts.produce(chain, image, b);
          }
        }
  } else {
    STAMP_BEGIN(true, 0);
    if (!kRing) {
      if (threadIdx.x == 0)
        wts.load_image(images + rank * image_bytes, base.image_bytes, own,
                       c * image_bytes);
      STAMP(1);
      mbar_wait(wts.full, 0);
    }
    const Thread t(threadIdx.x);
    Exchange ex(smem, lay, wg, out_dim);
    float4* st = reinterpret_cast<float4*>(smem + base.smem_stats) +
                 (wg * base.out_groups * 3) * kWgThreads + t.lt;
    const int groups = base.out_groups;
    const int last = L - 1;
    const size_t layer_stride = static_cast<size_t>(M) * kWidth;
    const bool relu_last = __ldg(relu + last) != 0;
    const uint32_t none[2] = {0u, 0u};
    float acc[64], acc_last[4];   // written by each layer's first product
    uint32_t a[8][4];
    for (int i = 0;; ++i) {
      const int tile = tiles.tile<kRing>(i);
      if (tile < 0) break;
      const long long row0 = static_cast<long long>(tile) * kRows;
      const int valid = tiles.valid(tile, B);
      const float* x_tile = x + (valid > 0 ? row0 * ldx : 0);
      for (int j = 0; j < own; ++j) {
        const int m = rank + j * c;
        if (!kRing) wts.base = smem + j * image_bytes;
        const float* bm = b_all + static_cast<size_t>(m) * kWidth;
        const float* b_last = bm + last * layer_stride;
        // member m's outputs of column group g: folded by the leader, sent
        // by a peer
        const auto deliver = [&](int g) {
          float v[4];
          last_values(acc_last, b_last, relu_last, g, t, v);
          if (rank == 0)
            stats_fold(v, g, m == 0, st);
          else
            ex.send(rank,
                    (static_cast<uint32_t>(i) * own + j) * groups + g, v, t);
        };
        if (L == 1) {   // one Linear: the last layer straight from x
          for (int g = 0; g < groups; ++g) {
            last_group_from_x(acc_last, wts, chain, x_tile, d, ldx, valid, t,
                              g, NoMask());
            deliver(g);
          }
        } else {
          layer0_from_x(acc, wts, chain, x_tile, d, ldx, valid, t, NoMask(),
                        [] {});
          epilogue<false, true>(acc, bm, __ldg(relu) != 0, none, 1.f, t, a);
          for (int l = 1; l < last; ++l) {
            const uint32_t addr = wts.acquire(chain, chain.nb0 + l - 1);
            issue_n128(acc, a, addr);
            wait_acc(acc, a);
            wts.release(t.lane0);
            epilogue<false, true>(acc, bm + l * layer_stride,
                                  __ldg(relu + l) != 0, none, 1.f, t, a);
          }
          const uint32_t addr = wts.acquire(chain, chain.nb0 + last - 1);
          for (int g = 0; g < groups; ++g) {
            last_group(acc_last, a, addr, g);
            deliver(g);
          }
          wts.release(t.lane0);
        }
        if (rank == 0) {
          fold_peers(ex, st, groups, min(c, M - j * c) - 1, M, c, i, j, t);
          if (j + 1 == own) {
            if (kPacked)
              stats_write(st, groups, M, t, valid, row0, out_dim, kWidth,
                          out0, out0 + out_dim);
            else
              stats_write(st, groups, M, t, valid, row0, out_dim, out_dim,
                          out0, out1);
          }
        }
      }
      if (kPacked) {   // zeros in columns [2 out_dim, 128): rows r = rank
                       // mod c of the tile, 16 bytes a store
        const int mine = (kRows - rank + c - 1) / c;
        for (int e = t.lt; e < mine * (kWidth / 4); e += kWgThreads) {
          const int r = rank + (e / (kWidth / 4)) * c;
          const int c4 = 4 * (e % (kWidth / 4));
          if (r >= valid || c4 + 4 <= 2 * out_dim) continue;
          float* q = out0 + (row0 + r) * kWidth + c4;
          if (c4 >= 2 * out_dim) {
            *reinterpret_cast<float4*>(q) = make_float4(0.f, 0.f, 0.f, 0.f);
          } else {
            for (int k = 2 * out_dim - c4; k < 4; ++k) q[k] = 0.f;
          }
        }
      }
    }
    STAMP_END();
  }
  cluster_sync();   // no block leaves while a peer may still reach into it
}

// ---------------------------------------------------------------------------
// The fp32 kernels 1 (the ensemble, ensemble_tf32 at the end), 2 (MC
// dropout) and 5 (anchored) on the tensor cores: each
// product in 3xTF32, a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms
// first), every term a wgmma.mma_async m64nNk8 TF32 product with A from
// registers, summed in the fp32 accumulator. An operand's hi part is
// tf32(v) and its lo part tf32(v - hi) (cvt.rna: round to nearest, ties
// away); the weights' parts are packed by the host (ops/fused_eval_chain.py
// chain_image), an activation's in the epilogue that makes it, after bias,
// ReLU and any dropout mask. The image streams through a ring of 32 KB
// slots (Ring) in blocks of at most 32 input rows, hi then lo (Chain32).
// A block runs one or two consumer warpgroups (two where their statistics
// fit), each on its own 64-row tile and all on the same passes, so every
// block that comes through the ring serves each of them; the first thread
// of each warpgroup is also the ring's producer (a producer warp would cost
// the consumers' registers: A's hi and lo parts, 64 each, and the
// accumulator, 64, take 192 of the 255 a thread of two warpgroups may
// hold). Kernels 2 and 5 split a tile's passes into kGroups groups, one
// for each block of a cluster of kGroups blocks; the leader (rank 0) merges
// the groups' moments in group order (Chan's formula). Kernel 1 splits its
// members over 1b's cluster and folds them in member order.

constexpr int kGroups = 8;       // groups of a tile's passes (GROUPS)
constexpr int kTfRows = 32;      // input rows of an fp32 image block
constexpr int kTfStreamBytes = 64;   // the producer's state (Stream)

// Whether the phase of `bar` with this parity has completed, without
// waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo (to 2^-22 relative), both TF32
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// acc (m64n128, fp32) = (scale_d ? acc : 0) + a (64 x 8 TF32, registers:
// rows r0, r0 + 8, inputs q, q + 4) x B (8 x 128 TF32, K-major at desc_b)
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// acc = a x B, the accumulator written only (its old values are dead)
__device__ __forceinline__ void wgmma_tf32_n128_first(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 z;\nmov.b32 z, 0;\nsetp.ne.b32 p, z, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d (64 x 8 fp32) = (scale_d ? d : 0) + a (64 x 8 TF32) x B (8 x 8 TF32)
__device__ __forceinline__ void wgmma_tf32_n8(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// Wait until at most one committed group of this warpgroup's products is
// in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// One k step (8 inputs) of 3xTF32 into the n128 accumulator; B's hi and lo
// parts at shared addresses bh and bl of blocks of R rows (stride byte
// offset 32 R, leading byte offset 128: the next 4 inputs).
__device__ __forceinline__ void step_n128(float (&acc)[64],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          uint32_t bh, uint32_t bl,
                                          uint32_t sbo, bool first) {
  if (first)
    wgmma_tf32_n128_first(acc, lo, desc(bh, 128, sbo));
  else
    wgmma_tf32_n128(acc, lo, desc(bh, 128, sbo), 1);
  wgmma_tf32_n128(acc, hi, desc(bl, 128, sbo), 1);
  wgmma_tf32_n128(acc, hi, desc(bh, 128, sbo), 1);
}

// The same with the first product's scale-d a value (0: overwrite the
// accumulator), not a branch between two forms: products chosen by a branch
// on a loop counter made ptxas serialise every wgmma of the kernel (C7520).
__device__ __forceinline__ void step_n128_at(float (&acc)[64],
                                             const uint32_t (&hi)[4],
                                             const uint32_t (&lo)[4],
                                             uint32_t bh, uint32_t bl,
                                             uint32_t sbo, int scale_d) {
  wgmma_tf32_n128(acc, lo, desc(bh, 128, sbo), scale_d);
  wgmma_tf32_n128(acc, hi, desc(bl, 128, sbo), 1);
  wgmma_tf32_n128(acc, hi, desc(bh, 128, sbo), 1);
}

// The same into an n8 accumulator.
__device__ __forceinline__ void step_n8(float (&acc)[4],
                                        const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4], uint32_t bh,
                                        uint32_t bl, uint32_t sbo,
                                        bool first) {
  wgmma_tf32_n8(acc, lo, desc(bh, 128, sbo), first ? 0 : 1);
  wgmma_tf32_n8(acc, hi, desc(bl, 128, sbo), 1);
  wgmma_tf32_n8(acc, hi, desc(bh, 128, sbo), 1);
}

// An fp32 chain's image (chain_image of fp32 weights, tf32_blocks): layer
// 0's d8 = ceil8(d) rows in blocks of 32 (the last one shorter), 128
// columns; 4 blocks of each hidden layer; the last layer's 4 blocks of 8
// columns for each column group. A one-Linear chain: layer 0's blocks of 8
// columns for each column group. Block b's hi image, then its lo image.
struct Chain32 {
  int d8, L, groups, nb0;

  __device__ __forceinline__ Chain32(int d, int layers, int out_groups)
      : d8((d + 7) & ~7),
        L(layers),
        groups(out_groups),
        nb0((((d + 7) & ~7) + kTfRows - 1) / kTfRows) {}

  __device__ __forceinline__ int blocks() const {
    return L == 1 ? groups * nb0 : nb0 + 4 * (L - 2) + 4 * groups;
  }
  __device__ __forceinline__ int rows(int b) const {
    const int k = L == 1 ? b % nb0 : b;
    return k < nb0 ? min(kTfRows, d8 - kTfRows * k) : kTfRows;
  }
  __device__ __forceinline__ int cols(int b) const {
    return L == 1 || b >= nb0 + 4 * (L - 2) ? 8 : kWidth;
  }
  __device__ __forceinline__ uint32_t offset(int b) const {
    if (L == 1) return (b / nb0) * d8 * 64u + (b % nb0) * 2048u;
    if (b < nb0) return b * 32768u;
    const uint32_t at = d8 * 1024u;
    b -= nb0;
    if (b < 4 * (L - 2)) return at + b * 32768u;
    return at + (L - 2) * 131072u + (b - 4 * (L - 2)) * 2048u;
  }
  __device__ __forceinline__ uint32_t bytes(int b) const {
    return 8u * rows(b) * cols(b);
  }
};

// The blocks every consumer warpgroup of a block takes, in order (the
// stream: the chain's blocks once for each pass of each round), and the
// producer's place in it: the next block, its slot and its use of that
// slot. In shared memory; the thread that holds `lock` reads and writes it.
// The ensemble's stream walks `members` images `stride` bytes apart, one
// pass through each in turn (`image` the current one, `member` its place).
struct Stream {
  const unsigned char* image;
  Chain32 chain;
  uint32_t issued, total;
  int block, slot, use, lock;
  int stride, member, members;
};
static_assert(sizeof(Stream) <= kTfStreamBytes, "Stream outgrew its bytes");

// The ring of an fp32 kernel: `slots` 32 KB slots at the start of shared
// memory, a full and an empty mbarrier each (every consumer warp arrives on
// `empty`). The first thread of each consumer warpgroup is also a
// producer: whenever it acquires a block it first issues every block of the
// stream whose slot all consumers have given back (one producer at a time,
// under the stream's lock; the other returns at once), and it goes on
// issuing while it waits, so no consumer waits on a block that only its
// own warpgroup's release would let it issue. (slot, phase) of the next
// block a thread takes and gives back step without a division; a consumer
// holds two blocks at most.
// kMembers: the stream walks several images in turn (the ensemble's).
template <bool kMembers = false>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  volatile Stream* stream;
  int slots;
  int take, take_phase, give;

  __device__ __forceinline__ Ring(unsigned char* smem, const Layout& lay)
      : base(smem),
        full(reinterpret_cast<uint64_t*>(smem + lay.smem_bars)),
        stream(reinterpret_cast<Stream*>(smem + lay.smem_bytes -
                                         kTfStreamBytes)),
        slots(lay.ring),
        take(0),
        take_phase(0),
        give(0) {}

  __device__ __forceinline__ uint64_t* empty() const { return full + slots; }

  // thread 0, before the fence of the barriers' initialisation: the
  // barriers, and the stream of `count` passes through the chain (with
  // kMembers, through `members` images `stride` bytes apart in turn)
  __device__ __forceinline__ void init(int warpgroups,
                                       const unsigned char* image,
                                       const Chain32& c, uint32_t count,
                                       int stride = 0, int members = 1) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty() + s, 4 * warpgroups);
    }
    Stream* st = const_cast<Stream*>(stream);
    st->image = image;
    st->chain = c;
    st->issued = 0;
    st->total = count * c.blocks();
    st->block = 0;
    st->slot = 0;
    st->use = 0;
    st->lock = 0;
    st->stride = stride;
    st->member = 0;
    st->members = members;
  }
  // a producer: issue every block of the stream whose slot is free
  __device__ __forceinline__ void pump() {
    volatile Stream& st = *stream;
    if (atomicCAS(const_cast<int*>(&st.lock), 0, 1) != 0) return;
    const Stream* plain = const_cast<const Stream*>(stream);
    const Chain32 c = plain->chain;
    const unsigned char* image = kMembers ? st.image : plain->image;
    const uint32_t total = st.total;
    uint32_t n = st.issued;
    int b = st.block, s = st.slot, use = st.use;
    int member = kMembers ? st.member : 0;
    while (n < total) {
      if (use > 0 && !mbar_test(empty() + s, (use - 1) & 1)) break;
      const uint32_t bytes = c.bytes(b);
      mbar_expect_tx(full + s, bytes);
      bulk_load(base + s * kSlotBytes, image + c.offset(b), bytes, full + s);
      ++n;
      if (++b == c.blocks()) {
        b = 0;
        if (kMembers) {   // the next image, the first after the last
          const int members = st.members, stride = st.stride;
          if (++member == members) {
            member = 0;
            image -= static_cast<long long>(members - 1) * stride;
          } else {
            image += stride;
          }
        }
      }
      if (++s == slots) {
        s = 0;
        ++use;
      }
    }
    st.issued = n;
    st.block = b;
    st.slot = s;
    st.use = use;
    if (kMembers) {
      st.member = member;
      st.image = image;
    }
    __threadfence_block();
    atomicExch(const_cast<int*>(&st.lock), 0);
  }
  // the shared-memory address of the next block, once it is there
  __device__ __forceinline__ uint32_t acquire() {
    STAMP(1);
    const int s = take;
    const uint32_t parity = static_cast<uint32_t>(take_phase);
    if (threadIdx.x % kWgThreads == 0) {
      pump();
      while (!mbar_test(full + s, parity)) pump();
    } else {
      mbar_wait(full + s, parity);
    }
    if (++take == slots) {
      take = 0;
      take_phase ^= 1;
    }
    return smem_u32(base) + s * kSlotBytes;
  }
  // the oldest block held, after the warp's products on it have completed
  __device__ __forceinline__ void release(bool lane0) {
    STAMP(10);
    __syncwarp();
    if (lane0) mbar_arrive(empty() + give);
    if (++give == slots) give = 0;
  }
};

// A thread's activation slot (i, h, e) (row r0 + 8 h, column 8 i + 2 q + e
// of the accumulator) is input q + 4 e of k step i in the A fragment:
// register h + 2 e of step i (rows r0, r0 + 8; inputs q, q + 4).
__device__ __forceinline__ constexpr int a_reg(int h, int e) {
  return h + 2 * e;
}

// The A fragment of k step s of x's tile rows (features 8 s + 2 q, + 1,
// through f as x_fragment's), split into hi and lo; zeros past `valid` rows
// and d features.
template <class F>
__device__ __forceinline__ void x_step(const float* x_tile, int d, int valid,
                                       int s, const Thread& t, const F& f,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t.r0 + 8 * h, c = 8 * s + 2 * t.q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = 0.f;
      if (r < valid && c + e < d)
        v = f(h, c + e, __ldg(x_tile + static_cast<long long>(r) * d + c + e));
      tf32_split(v, hi[a_reg(h, e)], lo[a_reg(h, e)]);
    }
  }
}

// acc (m64n128) = x's tile (through f) x layer 0, its blocks [0, nb0) taken
// from the ring in turn, one k step a product group; `last` runs while the
// last step's products fly.
template <class R, class F, class G>
__device__ __forceinline__ void x_layer_tf32(float (&acc)[64], R& ring,
                                             const Chain32& c,
                                             const float* x_tile, int d,
                                             int valid, const Thread& t,
                                             const F& f, const G& last) {
  for (int b = 0; b < c.nb0; ++b) {
    const uint32_t addr = ring.acquire();
    const int rows = c.rows(b), steps = rows / 8;
    for (int s = 0; s < steps; ++s) {
      STAMP(2);
      uint32_t hi[4], lo[4];
      x_step(x_tile, d, valid, kTfRows / 8 * b + s, t, f, hi, lo);
      STAMP(3);
      pin(hi);
      pin(lo);
      __syncwarp();
      wgmma_fence();
      step_n128_at(acc, hi, lo, addr + 256 * s,
                   addr + 4 * rows * kWidth + 256 * s, 32 * rows,
                   (b | s) == 0 ? 0 : 1);
      wgmma_commit();
      if (b + 1 == c.nb0 && s + 1 == steps) last();
      STAMP(5);
      wgmma_wait_all();
      pin(acc);
      pin(hi);
      pin(lo);
    }
    ring.release(t.lane0);
  }
}

// Column group g of a one-Linear chain's only layer from x (through f):
// acc = x's tile x its blocks of that group, taken from the ring in turn.
template <class R, class F>
__device__ __forceinline__ void x_group_tf32(float (&acc)[4], R& ring,
                                             const Chain32& c,
                                             const float* x_tile, int d,
                                             int valid, const Thread& t,
                                             const F& f) {
  for (int b = 0; b < c.nb0; ++b) {
    const uint32_t addr = ring.acquire();
    const int rows = c.rows(b), steps = rows / 8;
    for (int s = 0; s < steps; ++s) {
      STAMP(2);
      uint32_t hi[4], lo[4];
      x_step(x_tile, d, valid, kTfRows / 8 * b + s, t, f, hi, lo);
      STAMP(8);
      pin(hi);
      pin(lo);
      __syncwarp();
      wgmma_fence();
      step_n8(acc, hi, lo, addr + 256 * s, addr + 32 * rows + 256 * s,
              32 * rows, (b | s) == 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(hi);
      pin(lo);
    }
    ring.release(t.lane0);
  }
}

// A hidden layer: acc (m64n128) = (hi, lo) x its 4 blocks of 32 rows from
// the ring, a block's 12 products one group, each block given back once
// the next one's products are in flight; `during` runs while the last
// block's fly.
template <class R, class G>
__device__ __forceinline__ void hidden_tf32(float (&acc)[64],
                                            uint32_t (&hi)[16][4],
                                            uint32_t (&lo)[16][4], R& ring,
                                            const Thread& t,
                                            const G& during) {
  STAMP(3);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pin(hi[i]);
    pin(lo[i]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t addr = ring.acquire();
    STAMP(3);
    __syncwarp();
    wgmma_fence();   // after the wait, where the warpgroup runs together
#pragma unroll
    for (int s = 0; s < 4; ++s)
      step_n128(acc, hi[4 * j + s], lo[4 * j + s], addr + 256 * s,
                addr + 16384 + 256 * s, 1024, j == 0 && s == 0);
    wgmma_commit();
    if (j > 0) {
      STAMP(5);
      wgmma_wait_one();
      ring.release(t.lane0);
    }
  }
  during();
  STAMP(5);
  wgmma_wait_all();
  pin(acc);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pin(hi[i]);
    pin(lo[i]);
  }
  ring.release(t.lane0);
}

// The last layer, column group g: acc = (hi, lo) x its 4 blocks of 32 rows
// and 8 columns from the ring; waits.
template <class R>
__device__ __forceinline__ void last_group_tf32(float (&acc)[4],
                                                uint32_t (&hi)[16][4],
                                                uint32_t (&lo)[16][4],
                                                R& ring, const Thread& t) {
  STAMP(8);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pin(hi[i]);
    pin(lo[i]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t addr = ring.acquire();
    STAMP(8);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      step_n8(acc, hi[4 * j + s], lo[4 * j + s], addr + 256 * s,
              addr + 1024 + 256 * s, 1024, j == 0 && s == 0);
    wgmma_commit();
    if (j > 0) {
      wgmma_wait_one();
      ring.release(t.lane0);
    }
  }
  wgmma_wait_all();
  pin(acc);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pin(hi[i]);
    pin(lo[i]);
  }
  ring.release(t.lane0);
}

// The floor of a ReLU in fmaxf: 0 where one follows, -inf (the identity)
// where none does: one epilogue for every layer, a select and no branch
// (two instances of the epilogue, masked and not, took kernel 2 past its
// registers).
__device__ __forceinline__ float relu_floor(bool relu) {
  return relu ? 0.f : -__int_as_float(0x7f800000);
}

// The next layer's A from the accumulator: bias (fp32, 128), ReLU (`floor`,
// relu_floor), the keep bits (keep_bit) times `scale` (all ones and 1 for
// no mask: the same values), split into hi and lo where the TF32 A fragment
// wants each value (a_reg).
__device__ __forceinline__ void epilogue_tf32(const float (&acc)[64],
                                              const float* bias, float floor,
                                              const uint32_t (&keep)[2],
                                              float scale, const Thread& t,
                                              uint32_t (&hi)[16][4],
                                              uint32_t (&lo)[16][4]) {
  STAMP(6);
  const float* bq = bias + 2 * t.q;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bq + 8 * i));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = fmaxf(acc[4 * i + 2 * h + e] + (e ? b.y : b.x), floor);
        v *= (keep[i >> 3] >> keep_bit(i, h, e)) & 1u ? scale : 0.f;
        tf32_split(v, hi[i][a_reg(h, e)], lo[i][a_reg(h, e)]);
      }
    }
  }
}

// The anchored kernel's layer 0 of one anchor into A: (u + v) through the
// ReLU (`floor`), u = acc + b0 rounded first, as the plain version adds
// them (u = x W_bot + b0, then u + v_j).
__device__ __forceinline__ void anchor_epilogue_tf32(const float (&acc)[64],
                                                     const float* b0,
                                                     const float* v,
                                                     float floor,
                                                     const Thread& t,
                                                     uint32_t (&hi)[16][4],
                                                     uint32_t (&lo)[16][4]) {
  STAMP(7);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(b0 + 8 * i + 2 * t.q));
    const float2 w = __ldg(reinterpret_cast<const float2*>(v + 8 * i + 2 * t.q));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float u = acc[4 * i + 2 * h + e] + (e ? b.y : b.x);
        tf32_split(fmaxf(u + (e ? w.y : w.x), floor), hi[i][a_reg(h, e)],
                   lo[i][a_reg(h, e)]);
      }
    }
  }
}

// The moments of a group of n passes in the thread's slots of column group
// g from its shifted sums (st, stats_fold's): mean c + s1/n and M2 = s2 -
// n m1^2, m1 = s1/n, with n m1^2 rounded before the subtraction.
__device__ __forceinline__ void group_moments(const float4* st, int g,
                                              int n, float (&m)[4],
                                              float (&m2)[4]) {
  const float4* p = st + 3 * g * kWgThreads;
  const float4 c4 = p[0], a4 = p[kWgThreads], b4 = p[2 * kWgThreads];
  const float c[4] = {c4.x, c4.y, c4.z, c4.w};
  const float s1[4] = {a4.x, a4.y, a4.z, a4.w};
  const float s2[4] = {b4.x, b4.y, b4.z, b4.w};
  const float fn = static_cast<float>(n);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float m1 = s1[e] / fn;
    m[e] = c[e] + m1;
    m2[e] = __fsub_rn(s2[e], __fmul_rn(__fmul_rn(fn, m1), m1));
  }
}

// Passes of group g when a tile's `count` passes are split into kGroups
// groups (the first count % kGroups groups one more), and its first.
__device__ __forceinline__ int group_size(int count, int g) {
  return count / kGroups + (g < count % kGroups ? 1 : 0);
}
__device__ __forceinline__ int group_first(int count, int g) {
  return g * (count / kGroups) + min(g, count % kGroups);
}

// The groups of one tile meet in the leader: a peer (rank p >= 1) with
// passes sends each column group's moments (mean, then M2) into its
// exchange ring in the leader; the leader merges its own and the peers' in
// group order by Chan's formula (n = na + nb, delta = mb - ma, mean = ma +
// delta nb / n, M2 = M2a + M2b + delta^2 na nb / n) and writes mean and
// std = sqrt(max(M2, 0) / max(count - 1, 1)). `round`: the tile's place in
// the block's tiles (the same in every block of the cluster).
__device__ __forceinline__ void merge_groups(Exchange& ex, const float4* st,
                                             int groups, int count, int rank,
                                             uint32_t round, const Thread& t,
                                             int valid, long long row0,
                                             int out_dim, float* mean,
                                             float* std) {
  STAMP(9);
  const auto seq = [&](int g, int part) {
    return (round * groups + g) * 2u + part;
  };
  const int own = group_size(count, rank);
  if (rank != 0) {
    if (own == 0) return;
    for (int g = 0; g < groups; ++g) {
      float m[4], m2[4];
      group_moments(st, g, own, m, m2);
      ex.send(rank, seq(g, 0), m, t);
      ex.send(rank, seq(g, 1), m2, t);
    }
    return;
  }
  for (int g = 0; g < groups; ++g) {
    float m[4], m2[4];
    group_moments(st, g, own, m, m2);
    float na = static_cast<float>(own);
    for (int p = 1; p < kGroups; ++p) {
      const int np = group_size(count, p);
      if (np == 0) break;
      // each part's slot back once read: a ring of one slot holds one
      float mb[4], m2b[4];
      ex.read(p, seq(g, 0), t, mb);
      __syncwarp();
      if (t.lane0) ex.free_slot(p, seq(g, 0));
      ex.read(p, seq(g, 1), t, m2b);
      __syncwarp();
      if (t.lane0) ex.free_slot(p, seq(g, 1));
      STAMP(13);
      const float nb = static_cast<float>(np), n = na + nb;
      const float wb = nb / n, wab = na * nb / n;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float delta = mb[e] - m[e];
        m[e] += delta * wb;
        m2[e] += m2b[e] + delta * delta * wab;
      }
      na = n;
    }
    const float dof = static_cast<float>(count > 1 ? count - 1 : 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = t.r0 + 8 * (e >> 1), col = 8 * g + 2 * t.q + (e & 1);
      if (r < valid && col < out_dim) {
        const long long o = (row0 + r) * out_dim + col;
        mean[o] = m[e];
        std[o] = sqrtf(fmaxf(m2[e], 0.f) / dof);
      }
    }
  }
}

// Kernel 1's body (fp32, 3xTF32): the M members of the folded chain on x
// ((B, d) row-major); images: member m's fp32 chain image (chain_image,
// tf32_blocks) at images + m * image_bytes; b_all (L, M, 128). A cluster
// of c = min(M, 8) blocks runs the tiles of its unit, block r members r,
// r + c, ... of every tile of its warpgroups, their images streamed in
// turn through its ring (Ring<true>: each block reads its own members'
// images only); every warpgroup takes every round's blocks, past the last
// tile as a tile of no rows. A peer sends each member's last-layer outputs
// (the real columns' lanes) to the leader through the exchange (1b's); the
// leader folds its own member j c, then the peers' j c + 1, ..., in member
// order (member 0 the shift: fused_chain::write_stats' arithmetic, not
// Chan's merge), and writes mean and std.
__device__ __forceinline__ void ensemble_tf32(
    unsigned char* smem, const float* __restrict__ x, long long B, int d,
    const unsigned char* __restrict__ images, const float* __restrict__ b_all,
    int M, int L, const int* __restrict__ relu, int out_dim,
    float* __restrict__ mean, float* __restrict__ std,
    const EnsembleLayout& lay) {
  const int c = lay.cluster;
  const int rank = static_cast<int>(cluster_rank());
  const int own = (M - rank + c - 1) / c;   // members rank, rank + c, ...
  const Chain32 chain(d, L, lay.base.out_groups);
  Ring<true> ring(smem, lay.base);
  const int wg = threadIdx.x / kWgThreads;
  const Tiles tiles(B, lay.base, wg, static_cast<int>(gridDim.x) / c,
                    static_cast<int>(blockIdx.x) / c);
  if (threadIdx.x == 0) {
    Exchange::init(smem, lay);
    ring.init(lay.base.warpgroups,
              images + static_cast<long long>(rank) * lay.base.image_bytes,
              chain, static_cast<uint32_t>(tiles.rounds) * own,
              c * lay.base.image_bytes, own);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // every block's barriers are set before a peer's use
  STAMP_BEGIN(true, 0);
  const Thread t(threadIdx.x);
  Exchange ex(smem, lay, wg, out_dim);
  const int groups = lay.base.out_groups;
  float4* st = reinterpret_cast<float4*>(smem + lay.base.smem_stats) +
               (wg * groups * 3) * kWgThreads + t.lt;
  const int last = L - 1;
  const size_t layer_stride = static_cast<size_t>(M) * kWidth;
  const bool relu_last = __ldg(relu + last) != 0;
  const uint32_t all[2] = {~0u, ~0u};
  float acc[64], acc_last[4];   // written by each layer's first product
  uint32_t hi[16][4], lo[16][4];
  for (int i = 0; i < tiles.rounds; ++i) {
    const int tile = tiles.tile<true>(i);
    const long long row0 = static_cast<long long>(tile) * kRows;
    const int valid = tiles.valid(tile, B);
    const float* x_tile = x + (valid > 0 ? row0 * d : 0);
    for (int j = 0; j < own; ++j) {
      const int m = rank + j * c;
      const float* bm = b_all + static_cast<size_t>(m) * kWidth;
      const float* b_last = bm + last * layer_stride;
      // member m's outputs of column group g: folded by the leader, sent
      // by a peer
      const auto deliver = [&](int g) {
        float v[4];
        last_values(acc_last, b_last, relu_last, g, t, v);
        if (rank == 0)
          stats_fold(v, g, m == 0, st);
        else
          ex.send(rank, (static_cast<uint32_t>(i) * own + j) * groups + g, v,
                  t);
      };
      if (L == 1) {   // one Linear: the last layer straight from x
        for (int g = 0; g < groups; ++g) {
          x_group_tf32(acc_last, ring, chain, x_tile, d, valid, t, NoMask());
          deliver(g);
        }
      } else {
        x_layer_tf32(acc, ring, chain, x_tile, d, valid, t, NoMask(), [] {});
        epilogue_tf32(acc, bm, relu_floor(__ldg(relu) != 0), all, 1.f, t, hi,
                      lo);
        for (int l = 1; l < last; ++l) {
          hidden_tf32(acc, hi, lo, ring, t, [] {});
          epilogue_tf32(acc, bm + l * layer_stride,
                        relu_floor(__ldg(relu + l) != 0), all, 1.f, t, hi, lo);
        }
        for (int g = 0; g < groups; ++g) {
          last_group_tf32(acc_last, hi, lo, ring, t);
          deliver(g);
        }
      }
      if (rank == 0) {
        fold_peers(ex, st, groups, min(c, M - j * c) - 1, M, c, i, j, t);
        if (j + 1 == own)
          stats_write(st, groups, M, t, valid, row0, out_dim, out_dim, mean,
                      std);
      }
    }
  }
  STAMP_END();
  cluster_sync();   // no block leaves while a peer may still reach into it
}

// Host: launch `kernel` (an ensemble_pass instance taking `args`) as
// lay.base.grid / lay.cluster clusters of lay.cluster blocks.
template <class... P>
inline cudaLaunchConfig_t cluster_config(void (*kernel)(P...),
                                         const EnsembleLayout& lay,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(lay.base.grid));
  cfg.blockDim = dim3(static_cast<unsigned>(lay.base.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(lay.base.smem_bytes);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(lay.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class... P, class... A>
inline cudaError_t launch_cluster(void (*kernel)(P...),
                                  const EnsembleLayout& lay,
                                  cudaStream_t stream, A&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.base.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(kernel, lay, stream, attr);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<A&&>(args)...);
}

// The clusters of `kernel` at this layout that the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
template <class... P>
inline int max_clusters(void (*kernel)(P...), const EnsembleLayout& lay) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.base.smem_bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(kernel, lay, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace fused_chain_wgmma
