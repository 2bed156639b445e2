// Kernel 3 (the fused whole-epoch training step) redesigned for Hopper: one
// thread-block cluster per member. fused_train.cu (fp32) and
// fused_train_bf16.cu (bf16-mixed) drive it; the one-block form in
// fused_train.cuh stays as the attribution probe's device code, and this
// file takes from it only the configuration, the dropout hash and the
// optimizer (adam_kernel).
//
// What it computes: fused_train.cu's function, step for step (the plain
// version is ops/fused_train.py fused_epoch_reference).
//
// What bounds it: operations (a flagship step's products are 5.1e8 FLOP,
// 7.6 us at the fp32 peak), and on one SM per member, as the one-block form
// ran, a step took 645 us. Here a member is spread over a cluster of kC
// blocks on kC SMs:
// - block r of member m's cluster owns lanes [r * kL, (r + 1) * kL) of every
//   block's output: its columns of z = h W + b, their BatchNorm statistics,
//   EMA, x-hat and ReLU (sums over the batch inside the block, in a fixed
//   order), the same columns of every gradient (dW[:, own] = a^T d[:, own],
//   the bias, scale and shift gradients), and the same lanes of the input
//   gradient d W^T;
// - a product needs the whole input: each block writes its lanes of the
//   activation into every peer's shared memory (distributed shared memory,
//   DSMEM) and a cluster barrier follows; the backward exchanges the block
//   input a and the gradient d the same way, into two buffers. When the
//   batch does not fit (TrainLayout.resident false), the two exchange
//   buffers and the own-lane activations live in the member's scratch in
//   device memory (L2) instead, read past L1;
// - each layer's weight slice (W[:, own], K x kL, for the forward; W[own, :],
//   kL x 128, for d W^T) is copied with cp.async into a two-slot ring one
//   layer ahead, while the current layer's products, BatchNorm and ReLU run;
// - only blocks whose lanes reach below out_pad run the last layer and the
//   loss: the padded lanes' products disappear;
// - x-hat and 1/sigma of a block's lanes stay in its region of the scratch
//   for the backward; dropout masks are recomputed from the hash;
// - across members, as before: a sweep launch (joint mean only: every
//   member's forward writes its prediction), the step launch (the loss,
//   the backward, and each block's loss terms and sum of g^2, which rank 0
//   adds in rank order and hands to the optimizer), and adam_kernel. No
//   float atomics: every sum has a fixed order, so runs are bit-identical.
// The fp32 form runs true fp32 FFMAs (each thread a 4 x 4 register tile,
// sums in ascending order); elementwise steps round where the plain version
// does (__fmul_rn/__fadd_rn). The bf16 form (kBf16) runs the three products
// as mma.sync m16n8k16 with fp32 accumulation; the activations and d it
// exchanges travel as bf16 (rounded where they are written: the plain
// version rounds exactly those operands), the block's own a and the
// weights are rounded as the fragments are read; everything else is shared.
// The launch layout (cluster size, lanes, threads, residency, shared-memory
// carve-up, scratch offsets) comes from ops/fused_train.py train_layout;
// the entry checks it against the constants compiled here.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "fused_train.cuh"
#include "stamps.cuh"

namespace {

namespace cg = cooperative_groups;

// blocks per member: the portable cluster size (16 blocks, non-portable,
// ran no faster at the flagship: eight clusters of 16 at this shared-memory
// carve-up do not fit on the card at once)
constexpr int kC = 8;
constexpr int kL = kLanes / kC;    // lanes a block owns
constexpr int kQ = kL / 4;         // float4 groups of a block's lanes
constexpr int kT = 256;            // threads a block
constexpr int kWarpsT = kT / 32;
constexpr int kXS = kLanes + 4;    // exchange buffer row stride (fp32)
constexpr int kXSB = kLanes + 8;   // the same for the bf16 form's buffers
template <bool kBf16>
constexpr int kXSt = kBf16 ? kXSB : kXS;
constexpr int kWRS = kLanes + 4;   // backward weight slice row stride
constexpr int kWSlot = kL * kWRS;  // floats a ring slot
constexpr int kParts = kT / kL;    // threads summing one lane's column

// the launch layout, in the order of fused_train.py's LAYOUT_FIELDS
enum {
  kLayCluster, kLayLanes, kLayThreads, kLayResident, kLaySmemBytes,
  kLayOutBlocks, kLayXStride, kLayWSlot, kLaySmemX, kLaySmemD, kLaySmemW,
  kLaySmemRed, kLayMemberFloats, kLayScratchX, kLayBlockFloats,
  kLayScratchBlocks, kLayScratchD, kLayScratchZh, kLayScratchInv,
  kLayFields
};
struct Layout {
  long long v[kLayFields];
};

// lane parameters kept in the reduction area, kL floats each
enum { kPMu, kPInv, kPGam, kPBet, kPPGam, kPPBet, kNumPar = 8 };

// One block's view of its member's buffers.
struct Blk {
  float* x0;      // exchange buffers (B x kXS): forward ping-pong; a, d
  float* x1;
  float* d;       // own-lane activations or gradients (B x kL)
  float* a;       // the backward's block input on the block's lanes (B x kL)
  float* zring;   // resident: two slots (B x kL) of x-hat for the backward
  float* zh;      // own-lane x-hat per BatchNorm slot (n_bn x B x kL)
  float* inv;     // own-lane 1/sigma per slot (n_bn x kL)
  float* ring;    // two weight slots of kWSlot
  float* red;     // 4 x kT partial column sums
  float* col;     // 4 x kL column sums
  float* par;     // kNumPar x kL lane parameters
  float* warp;    // kWarpsT warp sums
  float* out;     // the block's loss terms and sum of g^2
  int m, rank, off, out_blocks;
  long long base, sbase;   // member's first slab and sigma rows
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Exchange-buffer reads: shared memory when resident, else device memory
// written by other SMs, read past L1 (after the cluster barrier).
template <bool kRes>
__device__ __forceinline__ float4 ldx4(const float* p) {
  if constexpr (kRes) return *reinterpret_cast<const float4*>(p);
  else return __ldcg(reinterpret_cast<const float4*>(p));
}

// The exchange buffers hold fp32 in the fp32 form and bf16 in the bf16 form,
// whose products round exactly those operands to bf16 (the forward's input
// h, and d); element (r, c) is at r * kXSt + c, and a bf16 buffer (rows of
// 16-byte multiples, for the broadcast's 16-byte copies) fits in the space
// of an fp32 one.
__device__ __forceinline__ uint32_t bits_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Write four of the block's lanes at element idx of exchange buffer x: the
// block's own copy (resident; broadcast() sends them on), or the member's
// (device memory).
template <bool kBf16, bool kRes>
__device__ __forceinline__ void put4(float* x, long long idx, float4 v) {
  if constexpr (kBf16) {
    const uint2 u = make_uint2(bits_bf16(v.x, v.y), bits_bf16(v.z, v.w));
    uint2* p = reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(x) +
                                        idx);
    if constexpr (kRes) *p = u;
    else __stcg(p, u);
  } else {
    if constexpr (kRes) *reinterpret_cast<float4*>(x + idx) = v;
    else __stcg(reinterpret_cast<float4*>(x + idx), v);
  }
}

__device__ __forceinline__ uint32_t map_rank(const float* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Resident: copy the block's lanes of exchange buffer x (rows < B, written
// by put4) into every other rank's copy through distributed shared memory,
// one peer at a time, each rank starting at the next rank up, so that at any
// moment each block receives from one sender. Device memory: nothing to do.
template <bool kBf16, bool kRes>
__device__ __forceinline__ void broadcast(const Blk& k, const float* x,
                                          int B) {
  if constexpr (kRes) {
    __syncthreads();
    for (int qi = 1; qi < kC; ++qi) {
      const int q = (k.rank + qi) % kC;
      const uint32_t base = map_rank(x, q);
      if constexpr (kBf16) {   // eight bf16 lanes a copy
        const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
        for (int e = threadIdx.x; e < B * (kL / 8); e += kT) {
          const int at = (e / (kL / 8)) * kXSB + k.off + (e % (kL / 8)) * 8;
          st_cluster4(base + 2u * at,
                      *reinterpret_cast<const float4*>(xb + at));
        }
      } else {
        for (int e = threadIdx.x; e < B * kQ; e += kT) {
          const int at = (e / kQ) * kXS + k.off + (e % kQ) * 4;
          st_cluster4(base + 4u * at,
                      *reinterpret_cast<const float4*>(x + at));
        }
      }
    }
  }
}

// The cluster barrier after writes into peers' buffers; device-memory
// exchange writes are fenced first.
template <bool kRes>
__device__ __forceinline__ void exchange_sync(cg::cluster_group& cl) {
  if constexpr (!kRes) __threadfence();
  cl.sync();
}

template <bool kRes>
__device__ Blk make_blk(const Args& A, const Layout& lay, float* smem,
                        cg::cluster_group& cl) {
  Blk k;
  const long long B = A.i[kB];
  k.rank = static_cast<int>(cl.block_rank());
  k.m = static_cast<int>(blockIdx.x) / kC;
  k.off = k.rank * kL;
  k.out_blocks = static_cast<int>(lay.v[kLayOutBlocks]);
  k.base = k.m * A.i[kSlabRows];
  k.sbase = k.m * A.i[kSigRows];
  float* member = A.scratch + k.m * lay.v[kLayMemberFloats];
  float* block = member + lay.v[kLayScratchBlocks] +
                 k.rank * lay.v[kLayBlockFloats];
  if constexpr (kRes) {
    k.x0 = smem + lay.v[kLaySmemX];
    k.d = smem + lay.v[kLaySmemD];
  } else {
    k.x0 = member + lay.v[kLayScratchX];
    k.d = block + lay.v[kLayScratchD];
  }
  k.x1 = k.x0 + B * kXS;
  k.a = k.d + B * kL;
  k.zring = kRes ? k.a + B * kL : nullptr;
  k.zh = block + lay.v[kLayScratchZh];
  k.inv = block + lay.v[kLayScratchInv];
  k.ring = smem + lay.v[kLaySmemW];
  k.red = smem + lay.v[kLaySmemRed];
  k.col = k.red + 4 * kT;
  k.par = k.col + 4 * kL;
  k.warp = k.par + kNumPar * kL;
  k.out = k.warp + kWarpsT;
  return k;
}

// col[s][n] = sum over rows r of f(r, n)[s], s < N, for the block's kL
// lanes, in a fixed order: kParts threads per lane sum every kParts-th row,
// then one thread adds their partial sums in order.
template <int N, class F>
__device__ void lane_sums(int rows, F f, const Blk& k) {
  const int n = threadIdx.x % kL, part = threadIdx.x / kL;
  float acc[N];
#pragma unroll
  for (int s = 0; s < N; ++s) acc[s] = 0.f;
  for (int r = part; r < rows; r += kParts) {
    float val[N];
    f(r, n, val);
#pragma unroll
    for (int s = 0; s < N; ++s) acc[s] = __fadd_rn(acc[s], val[s]);
  }
#pragma unroll
  for (int s = 0; s < N; ++s) k.red[s * kT + threadIdx.x] = acc[s];
  __syncthreads();
  if (threadIdx.x < kL) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      float t = 0.f;
      for (int p = 0; p < kParts; ++p)
        t = __fadd_rn(t, k.red[s * kT + p * kL + threadIdx.x]);
      k.col[s * kL + threadIdx.x] = t;
    }
  }
  __syncthreads();
}

// The block's sum of one value per thread, in a fixed order; every thread
// gets it.
__device__ float blk_sum(float v, const Blk& k) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) k.warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarpsT; ++w) total = __fadd_rn(total, k.warp[w]);
  __syncthreads();
  return total;
}

struct Mask {
  bool on;
  uint32_t salt;
  float keep, inv_keep;
};

// The dropout mask of block li's input (off when it has none).
__device__ __forceinline__ Mask mask_of(const Args& A, int step, int m,
                                        const int* L) {
  Mask mk{L[kMaskIdx] >= 0, 0u, 1.f, 1.f};
  if (mk.on) {
    const int slot = L[kMaskIdx];
    mk.keep = __fsub_rn(1.0f, A.drops[slot]);
    mk.inv_keep = __fdiv_rn(1.0f, mk.keep);
    mk.salt = mask_salt(A, step, m, slot);
  }
  return mk;
}

__device__ __forceinline__ float masked(const Mask& mk, float v, int r,
                                        int c) {
  return mk.on ? __fmul_rn(v, mask_value(mk.salt, r, c, mk.keep, mk.inv_keep))
               : v;
}

// ---------------------------------------------------------------------------
// the weight ring
// ---------------------------------------------------------------------------
// Forward slice of block li: W[k][off + n] -> dst[k * kL + n], k < K.
__device__ __forceinline__ void fetch_fwd(const Args& A, const Blk& k, int li,
                                          float* dst) {
  const int* L = lin_row(A, li);
  const float* W = A.theta + (k.base + L[kWOff]) * kLanes + k.off;
  const int K = L[kInRows];
  for (int e = threadIdx.x; e < K * kQ; e += kT) {
    const int r = e / kQ, j = e % kQ;
    cp16(dst + r * kL + 4 * j, W + static_cast<long long>(r) * kLanes + 4 * j);
  }
  cp_commit();
}

// Backward slice of block li (li >= 1, K = 128): W[off + j][n] ->
// dst[j * kWRS + n].
__device__ __forceinline__ void fetch_bwd(const Args& A, const Blk& k, int li,
                                          float* dst) {
  const int* L = lin_row(A, li);
  const float* W = A.theta + (k.base + L[kWOff] + k.off) * kLanes;
  for (int e = threadIdx.x; e < kL * (kLanes / 4); e += kT) {
    const int j = e / (kLanes / 4), c = e % (kLanes / 4);
    cp16(dst + j * kWRS + 4 * c, W + j * kLanes + 4 * c);
  }
  cp_commit();
}

// ---------------------------------------------------------------------------
// the three products, fp32 (true FFMA, ascending sums)
// ---------------------------------------------------------------------------
// The fp32 products read shared memory at a rate that bounds them: a
// 4 x 4 register tile per thread halves the bytes each FMA needs against a
// 4 x 2 one, so they run on the kTiles threads that a 128-row pass (or the
// weight gradient's kL x 128) needs, and the others wait at the next
// barrier. Sums run in ascending order of the reduction index.
constexpr int kCQ = kL / 4;        // column quads of a block's lanes
constexpr int kTiles = 32 * kCQ;   // 4 x 4 tiles of a 128 x kL output

// out (B x kL) = X (B x K, stride kXS) Wf (K x kL) + bias (own lanes)
template <bool kRes>
__device__ void xw_f32(int B, int K, const float* X, const float* Wf,
                       const float* bias, float* out) {
  if (threadIdx.x >= kTiles) return;
  const int c0 = 4 * (threadIdx.x % kCQ), rq = threadIdx.x / kCQ;
  const float bv[4] = {bias[c0], bias[c0 + 1], bias[c0 + 2], bias[c0 + 3]};
  for (int p0 = 0; p0 < B; p0 += 128) {
    float acc[4][4];
    const float* xr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      xr[i] = X + static_cast<long long>(min(p0 + 4 * rq + i, B - 1)) * kXS;
    }
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 4) {
      float w[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(Wf + (k0 + q) * kL + c0);
        w[q][0] = v.x; w[q][1] = v.y; w[q][2] = v.z; w[q][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ldx4<kRes>(xr[i] + k0);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv[q], w[q][j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = p0 + 4 * rq + i;
      if (r < B)
        *reinterpret_cast<float4*>(out + r * kL + c0) = make_float4(
            __fadd_rn(acc[i][0], bv[0]), __fadd_rn(acc[i][1], bv[1]),
            __fadd_rn(acc[i][2], bv[2]), __fadd_rn(acc[i][3], bv[3]));
    }
  }
}

// g (rows x N, row stride 128) = A^T (rows x B) Xd (B x N): the weight
// gradient's rows of the block's input lanes (A, B x kL, the block input a
// on those lanes; rows <= kL of them valid) against every lane of d
template <bool kRes>
__device__ void atd_f32(int B, int rows, int N, const float* A, const float* Xd,
                        float* g) {
  if (threadIdx.x >= kTiles) return;
  const int k0 = 4 * (threadIdx.x / 32), n0 = 4 * (threadIdx.x % 32);
  if (n0 >= N) return;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const float4 x = ldx4<kRes>(Xd + static_cast<long long>(b) * kXS + n0);
    const float4 a = *reinterpret_cast<const float4*>(A + b * kL + k0);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k0 + i < rows)
      *reinterpret_cast<float4*>(g + (k0 + i) * kLanes + n0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// out (B x kL) = (Xd (B x N) Wr^T) * mask, Wr (kL x N, stride kWRS) the
// weight rows of the block's input lanes; a thread's columns are cq,
// cq + kCQ, .. so that its four weight rows sit on distinct banks
template <bool kRes>
__device__ void dwt_f32(int B, int N, const float* Xd, const float* Wr,
                        float* out, const Mask& mk, int off) {
  if (threadIdx.x >= kTiles) return;
  const int cq = threadIdx.x % kCQ, rq = threadIdx.x / kCQ;
  for (int p0 = 0; p0 < B; p0 += 128) {
    float acc[4][4];
    const float* xr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      xr[i] = Xd + static_cast<long long>(min(p0 + 4 * rq + i, B - 1)) * kXS;
    }
#pragma unroll 2
    for (int n0 = 0; n0 < N; n0 += 4) {
      float w[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(Wr + (cq + kCQ * j) * kWRS + n0);
        w[j][0] = v.x; w[j][1] = v.y; w[j][2] = v.z; w[j][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ldx4<kRes>(xr[i] + n0);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv[q], w[j][q], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = p0 + 4 * rq + i;
      if (r >= B) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cq + kCQ * j;
        out[r * kL + c] = masked(mk, acc[i][j], r, off + c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the three products, bf16 (mma.sync m16n8k16, operands rounded as read)
// ---------------------------------------------------------------------------

// c += a (16 x 16, row-major) b (16 x 8, column-major), fp32 accumulation
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 of an exchange buffer (resident: shared memory; else device
// memory written by other SMs, read past L1), and one.
template <bool kRes>
__device__ __forceinline__ uint32_t ldb2(const __nv_bfloat16* p) {
  if constexpr (kRes) return *reinterpret_cast<const uint32_t*>(p);
  else return __ldcg(reinterpret_cast<const unsigned int*>(p));
}
template <bool kRes>
__device__ __forceinline__ uint32_t ldb1(const __nv_bfloat16* p) {
  if constexpr (kRes) return *reinterpret_cast<const unsigned short*>(p);
  else return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

// The A fragment of rows r0.. (16) and columns k0.. (16) of the bf16
// exchange buffer X (row stride kXSB), columns >= K read as 0, rows clamped
// to B - 1.
template <bool kRes>
__device__ __forceinline__ void frag_rows(const float* X, int B, int K, int r0,
                                          int k0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* Xb = reinterpret_cast<const __nv_bfloat16*>(X);
  const __nv_bfloat16* ra =
      Xb + static_cast<long long>(min(r0 + g, B - 1)) * kXSB;
  const __nv_bfloat16* rb =
      Xb + static_cast<long long>(min(r0 + g + 8, B - 1)) * kXSB;
  const int c0 = k0 + 2 * q, c1 = c0 + 8;
  a[0] = c0 < K ? ldb2<kRes>(ra + c0) : 0u;
  a[1] = c0 < K ? ldb2<kRes>(rb + c0) : 0u;
  a[2] = c1 < K ? ldb2<kRes>(ra + c1) : 0u;
  a[3] = c1 < K ? ldb2<kRes>(rb + c1) : 0u;
}

// out (B x kL) = bf16(X) bf16(Wf) + bias, rows in 16-row tiles over the
// warps, every n8 tile of the block's lanes
template <bool kRes>
__device__ void xw_bf16(int B, int K, const float* X, const float* Wf,
                        const float* bias, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int r0 = warp * 16; r0 < B; r0 += kWarpsT * 16) {
    float acc[kL / 8][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      frag_rows<kRes>(X, B, K, r0, k0, a);
      const int ka = k0 + 2 * q, kb = ka + 8;
#pragma unroll
      for (int nt = 0; nt < kL / 8; ++nt) {
        const int n = nt * 8 + g;
        const uint32_t b0 = ka < K ? bits_bf16(Wf[ka * kL + n],
                                               Wf[(ka + 1) * kL + n]) : 0u;
        const uint32_t b1 = kb < K ? bits_bf16(Wf[kb * kL + n],
                                               Wf[(kb + 1) * kL + n]) : 0u;
        mma16816(acc[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kL / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r >= B) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nt * 8 + 2 * q + j;
          out[r * kL + n] = __fadd_rn(acc[nt][2 * h + j], bias[n]);
        }
      }
  }
}

// g (rows x N, row stride 128) = bf16(A)^T bf16(Xd), as atd_f32: one m16
// tile of the block's kL input lanes (rows >= kL read as 0), the n8 tiles
// of d over the warps, the reduction over the batch in 16-row steps (rows
// >= B read as 0)
template <bool kRes>
__device__ void atd_bf16(int B, int rows, int N, const float* A,
                         const float* Xd, float* gout) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int nt = warp; nt * 8 < N; nt += kWarpsT) {
    float acc[4] = {};
    const int n = nt * 8 + g;
    for (int b0 = 0; b0 < B; b0 += 16) {
      const int ba = b0 + 2 * q, bb = ba + 8;
      const bool va = ba < B, vb = bb < B;
      uint32_t a[4];
      a[0] = va ? bits_bf16(A[ba * kL + g], A[(ba + 1) * kL + g]) : 0u;
      a[1] = va && g + 8 < kL
                 ? bits_bf16(A[ba * kL + g + 8], A[(ba + 1) * kL + g + 8]) : 0u;
      a[2] = vb ? bits_bf16(A[bb * kL + g], A[(bb + 1) * kL + g]) : 0u;
      a[3] = vb && g + 8 < kL
                 ? bits_bf16(A[bb * kL + g + 8], A[(bb + 1) * kL + g + 8]) : 0u;
      const __nv_bfloat16* Xb = reinterpret_cast<const __nv_bfloat16*>(Xd);
      const __nv_bfloat16* xa = Xb + static_cast<long long>(ba) * kXSB + n;
      const __nv_bfloat16* xb = Xb + static_cast<long long>(bb) * kXSB + n;
      const uint32_t b0r =
          va ? ldb1<kRes>(xa) | (ldb1<kRes>(xa + kXSB) << 16) : 0u;
      const uint32_t b1r =
          vb ? ldb1<kRes>(xb) | (ldb1<kRes>(xb + kXSB) << 16) : 0u;
      mma16816(acc, a, b0r, b1r);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = g + 8 * h;
      if (k >= rows) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        gout[k * kLanes + nt * 8 + 2 * q + j] = acc[2 * h + j];
    }
  }
}

// out (B x kL) = (bf16(Xd) bf16(Wr)^T) * mask, the reduction over N lanes
template <bool kRes>
__device__ void dwt_bf16(int B, int N, const float* Xd, const float* Wr,
                         float* out, const Mask& mk, int off) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int r0 = warp * 16; r0 < B; r0 += kWarpsT * 16) {
    float acc[kL / 8][4] = {};
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t a[4];
      frag_rows<kRes>(Xd, B, N, r0, n0, a);
      const int na = n0 + 2 * q, nb = na + 8;
#pragma unroll
      for (int nt = 0; nt < kL / 8; ++nt) {
        const float* w = Wr + (nt * 8 + g) * kWRS;
        const float2 wa = *reinterpret_cast<const float2*>(w + na);
        const float2 wb = *reinterpret_cast<const float2*>(w + nb);
        const uint32_t b0 = na < N ? bits_bf16(wa.x, wa.y) : 0u;
        const uint32_t b1 = nb < N ? bits_bf16(wb.x, wb.y) : 0u;
        mma16816(acc[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kL / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r >= B) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nt * 8 + 2 * q + j;
          out[r * kL + n] = masked(mk, acc[nt][2 * h + j], r, off + n);
        }
      }
  }
}

template <bool kBf16, bool kRes>
__device__ __forceinline__ void xw(int B, int K, const float* X,
                                   const float* Wf, const float* bias,
                                   float* out) {
  if constexpr (kBf16) xw_bf16<kRes>(B, K, X, Wf, bias, out);
  else xw_f32<kRes>(B, K, X, Wf, bias, out);
}

template <bool kBf16, bool kRes>
__device__ __forceinline__ void atd(int B, int rows, int N, const float* A,
                                    const float* Xd, float* gout) {
  if constexpr (kBf16) atd_bf16<kRes>(B, rows, N, A, Xd, gout);
  else atd_f32<kRes>(B, rows, N, A, Xd, gout);
}

template <bool kBf16, bool kRes>
__device__ __forceinline__ void dwt(int B, int N, const float* Xd,
                                    const float* Wr, float* out,
                                    const Mask& mk, int off) {
  if constexpr (kBf16) dwt_bf16<kRes>(B, N, Xd, Wr, out, mk, off);
  else dwt_f32<kRes>(B, N, Xd, Wr, out, mk, off);
}

// ---------------------------------------------------------------------------
// the step's parts
// ---------------------------------------------------------------------------
// Block 0's input x (masked by its dropout slot) into exchange buffer X:
// every row into the block's own copy (resident), or rows rank, rank + kC,
// .. into the member's (device memory; the caller's barrier follows).
template <bool kBf16, bool kRes>
__device__ void load_x(const Args& A, const Blk& k, int step, float* X) {
  const int B = static_cast<int>(A.i[kB]);
  const int in_pad = static_cast<int>(A.i[kInPad]);
  const int* L0 = lin_row(A, 0);
  const int K = L0[kInRows];
  const Mask mk = mask_of(A, step, k.m, L0);
  const float* x = A.xs + static_cast<long long>(step) * B * in_pad;
  const int q4 = K / 4;
  if constexpr (kRes) {
    for (int e = threadIdx.x; e < B * q4; e += kT) {
      const int r = e / q4, c = (e % q4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(x + r * in_pad + c);
      float4 w;
      w.x = masked(mk, v.x, r, c);
      w.y = masked(mk, v.y, r, c + 1);
      w.z = masked(mk, v.z, r, c + 2);
      w.w = masked(mk, v.w, r, c + 3);
      put4<kBf16, true>(X, static_cast<long long>(r) * kXSt<kBf16> + c, w);
    }
  } else {
    const int rows = (B - k.rank + kC - 1) / kC;
    for (int e = threadIdx.x; e < rows * q4; e += kT) {
      const int r = k.rank + (e / q4) * kC, c = (e % q4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(x + r * in_pad + c);
      float4 w;
      w.x = masked(mk, v.x, r, c);
      w.y = masked(mk, v.y, r, c + 1);
      w.z = masked(mk, v.z, r, c + 2);
      w.w = masked(mk, v.w, r, c + 3);
      put4<kBf16, false>(X, static_cast<long long>(r) * kXSt<kBf16> + c, w);
    }
  }
}

// BatchNorm of block li on the block's lanes of z (in k.d): batch
// statistics, the running-stat EMA, 1/sigma and x-hat kept for the
// backward, then h = ReLU?(x-hat * scale + shift), masked by block li+1's
// dropout slot, written into every peer's exchange buffer Xout.
template <bool kBf16, bool kRes>
__device__ void bn_forward(const Args& A, const Blk& k, int step, int li,
                           float* Xout, int sid) {
  const int B = static_cast<int>(A.i[kB]);
  const float fB = static_cast<float>(B);
  const int* L = lin_row(A, li);
  const float* D = k.d;
  lane_sums<1>(B, [&](int r, int n, float* val) { val[0] = D[r * kL + n]; }, k);
  if (threadIdx.x < kL)
    k.par[kPMu * kL + threadIdx.x] = __fdiv_rn(k.col[threadIdx.x], fB);
  __syncthreads();
  lane_sums<1>(B, [&](int r, int n, float* val) {
    const float c = __fsub_rn(D[r * kL + n], k.par[kPMu * kL + n]);
    val[0] = __fmul_rn(c, c);
  }, k);
  const int zi = L[kZhIdx];
  if (threadIdx.x < kL) {
    const int n = threadIdx.x, lane = k.off + n;
    const float mu = k.par[kPMu * kL + n];
    const float var = __fdiv_rn(k.col[n], fB);
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, A.f[kBnEps])));
    k.par[kPInv * kL + n] = inv;
    k.inv[zi * kL + n] = inv;
    k.par[kPGam * kL + n] = A.theta[(k.base + L[kGOff]) * kLanes + lane];
    k.par[kPBet * kL + n] = A.theta[(k.base + L[kBeOff]) * kLanes + lane];
    float* mo = A.sigma + (k.sbase + L[kMeanOff]) * kLanes + lane;
    float* vo = A.sigma + (k.sbase + L[kVarOff]) * kLanes + lane;
    *mo = __fadd_rn(__fmul_rn(A.f[kOneMinusMom], *mo),
                    __fmul_rn(A.f[kMom], mu));
    *vo = __fadd_rn(__fmul_rn(A.f[kOneMinusMom], *vo),
                    __fmul_rn(A.f[kMom], __fmul_rn(var, A.f[kUnbias])));
  }
  __syncthreads();
  STAMP(sid + 4);
  const bool relu = L[kRelu] != 0;
  const Mask mk = mask_of(A, step, k.m, lin_row(A, li + 1));
  float* zh = k.zh + static_cast<long long>(zi) * B * kL;
  for (int e = threadIdx.x; e < B * kQ; e += kT) {
    const int r = e / kQ, n0 = (e % kQ) * 4;
    const float4 z4 = *reinterpret_cast<const float4*>(D + r * kL + n0);
    const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
    float xh[4], hv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + j;
      xh[j] = __fmul_rn(__fsub_rn(zv[j], k.par[kPMu * kL + n]),
                        k.par[kPInv * kL + n]);
      float h = __fadd_rn(__fmul_rn(xh[j], k.par[kPGam * kL + n]),
                          k.par[kPBet * kL + n]);
      if (relu) h = fmaxf(h, 0.f);
      hv[j] = masked(mk, h, r, k.off + n);
    }
    *reinterpret_cast<float4*>(zh + r * kL + n0) =
        make_float4(xh[0], xh[1], xh[2], xh[3]);
    put4<kBf16, kRes>(Xout,
                      static_cast<long long>(r) * kXSt<kBf16> + k.off + n0,
                      make_float4(hv[0], hv[1], hv[2], hv[3]));
  }
  STAMP(sid + 5);
  broadcast<kBf16, kRes>(k, Xout, B);
}

// The member's training-mode forward with the EMA: block 0's input must be
// in k.x0 (and the cluster synchronised). The last block's output lanes are
// left in k.d by the blocks that own lanes below out_pad. Weight slices
// come through the ring from index *s on; with `then_bwd`, the last layer
// also prefetches the backward's first slice.
template <bool kBf16, bool kRes>
__device__ void cluster_forward(const Args& A, const Blk& k, int step, int& s,
                                bool then_bwd, cg::cluster_group& cl) {
  const int sbase = then_bwd ? 300 : 100;   // stamp ids: step, sweep
  const int B = static_cast<int>(A.i[kB]);
  const int n = static_cast<int>(A.i[kNLins]);
  float* xin = k.x0;
  float* xout = k.x1;
  for (int li = 0; li < n; ++li) {
    const int* L = lin_row(A, li);
    const bool last = li == n - 1;
    cp_wait_all();
    __syncthreads();
    float* next = k.ring + ((s + 1) & 1) * kWSlot;
    if (!last)
      fetch_fwd(A, k, li + 1, next);
    else if (then_bwd && n >= 2)
      fetch_bwd(A, k, n - 1, next);
    const float* wf = k.ring + (s & 1) * kWSlot;
    ++s;
    STAMP(sbase + 10 * li);
    if (!last || k.rank < k.out_blocks)
      xw<kBf16, kRes>(B, L[kInRows], xin, wf,
                      A.theta + (k.base + L[kBOff]) * kLanes + k.off, k.d);
    __syncthreads();
    STAMP(sbase + 10 * li + 1);
    if (last) break;
    bn_forward<kBf16, kRes>(A, k, step, li, xout, sbase + 10 * li);
    STAMP(sbase + 10 * li + 2);
    exchange_sync<kRes>(cl);
    STAMP(sbase + 10 * li + 3);
    float* t = xin;
    xin = xout;
    xout = t;
  }
}

// The loss on the block's lanes of the prediction in k.d (lanes below
// out_pad only): d = dL/dpred / div * inv_members, in place; returns the
// block's loss-term sum.
__device__ float cluster_loss(const Args& A, const Blk& k, int step) {
  const int B = static_cast<int>(A.i[kB]);
  const int out_pad = static_cast<int>(A.i[kOutPad]);
  const float* y = A.ys + static_cast<long long>(step) * B * out_pad;
  const float div = A.f[kLossDiv], inv_m = A.f[kInvMembers];
  const int out_w = lin_row(A, static_cast<int>(A.i[kNLins]) - 1)[kOutW];
  float* d = k.d;
  float term = 0.f;
  if (A.i[kLoss] == kNll) {
    // lanes 0 and 1 (rank 0: out_pad 8 <= kL)
    for (int r = threadIdx.x; r < B; r += kT) {
      const float raw = d[r * kL + 1];
      const float mu = d[r * kL];
      const float var = __fadd_rn(softplus(raw), 1e-6f);
      const float inv = __fdiv_rn(1.0f, var);
      const float diff = __fsub_rn(mu, y[r * out_pad]);
      const float sq = __fmul_rn(diff, diff);
      term = __fadd_rn(term, __fadd_rn(__fmul_rn(0.5f, logf(var)),
                                       __fmul_rn(__fmul_rn(0.5f, sq), inv)));
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-raw)));
      d[r * kL] = __fmul_rn(__fdiv_rn(__fmul_rn(diff, inv), div), inv_m);
      const float dr = __fsub_rn(inv, __fmul_rn(__fmul_rn(sq, inv), inv));
      d[r * kL + 1] = __fmul_rn(
          __fdiv_rn(__fmul_rn(__fmul_rn(0.5f, dr), sig), div), inv_m);
      for (int n = 2; n < kL; ++n) d[r * kL + n] = 0.f;
    }
  } else {
    // lane by lane, rows across the threads, so that the target loads of
    // the lanes below out_pad spread over the block
    for (int e = threadIdx.x; e < B * kL; e += kT) {
      const int r = e % B, c = e / B, lane = k.off + c;
      const float yv = lane < out_pad ? y[r * out_pad + lane] : 0.f;
      const float diff = __fsub_rn(d[r * kL + c], yv);
      float gv;
      if (A.i[kLoss] == kL1) {
        term = __fadd_rn(term, fabsf(diff));
        const float one = lane < out_w ? 1.f : 0.f;
        gv = __fdiv_rn(diff >= 0.f ? one : -one, div);
      } else {
        term = __fadd_rn(term, __fmul_rn(diff, diff));
        gv = __fdiv_rn(__fmul_rn(2.0f, diff), div);
      }
      d[r * kL + c] = __fmul_rn(gv, inv_m);
    }
  }
  return blk_sum(term, k);
}

// Start copying the x-hat of BatchNorm slot zi (the block's lanes) from the
// scratch into ring slot `slot` (resident only).
__device__ __forceinline__ void fetch_zh(const Blk& k, int B, int zi,
                                         int slot) {
  const float* src = k.zh + static_cast<long long>(zi) * B * kL;
  float* dst = k.zring + static_cast<long long>(slot) * B * kL;
  for (int e = threadIdx.x; e < B * kQ; e += kT)
    cp16(dst + 4 * e, src + 4 * e);
  cp_commit();
}

// The reverse pass of the member from d (the block's lanes of dL/d(output)
// of the last block, in k.d) into g: each block's output lanes of the bias,
// BatchNorm scale and shift gradients, and the weight gradient's rows of
// the block's input lanes, dW[own, :] = a[:, own]^T d, from its own lanes of
// the block input a and the whole of d, which the blocks exchange; d W^T
// on the block's input lanes from the same d. Backward weight slices come
// through the ring from index *s on (the last block's already requested).
template <bool kBf16, bool kRes>
__device__ void cluster_backward(const Args& A, const Blk& k, int step, int& s,
                                 cg::cluster_group& cl) {
  const int B = static_cast<int>(A.i[kB]);
  const float fB = static_cast<float>(B);
  const int n = static_cast<int>(A.i[kNLins]);
  float* D = k.d;
  float* Xd = k.x1;
  for (int li = n - 1; li >= 0; --li) {
    const int* L = lin_row(A, li);
    const bool last = li == n - 1;
    const bool owner = !last || k.rank < k.out_blocks;
    const int* P = li >= 1 ? lin_row(A, li - 1) : nullptr;
    const float* wr = nullptr;
    if (li >= 1) {
      // this block's weight slice and x-hat have arrived; request the
      // previous block's, its x-hat (resident) for the block input a below
      cp_wait_all();
      __syncthreads();
      if (li >= 2) fetch_bwd(A, k, li - 1, k.ring + ((s + 1) & 1) * kWSlot);
      if constexpr (kRes) fetch_zh(k, B, P[kZhIdx], (li - 1) & 1);
      wr = k.ring + (s & 1) * kWSlot;
      ++s;
    }
    STAMP(500 + 10 * li);
    const int zi = L[kZhIdx];
    const float* zh =
        zi < 0 ? nullptr
               : kRes ? k.zring + static_cast<long long>(li & 1) * B * kL
                      : k.zh + static_cast<long long>(zi) * B * kL;
    if (threadIdx.x < kL) {
      const int lane = k.off + threadIdx.x;
      if (L[kGOff] >= 0) {
        k.par[kPGam * kL + threadIdx.x] =
            A.theta[(k.base + L[kGOff]) * kLanes + lane];
        k.par[kPBet * kL + threadIdx.x] =
            A.theta[(k.base + L[kBeOff]) * kLanes + lane];
        k.par[kPInv * kL + threadIdx.x] = k.inv[zi * kL + threadIdx.x];
      }
      if (P) {
        k.par[kPPGam * kL + threadIdx.x] =
            A.theta[(k.base + P[kGOff]) * kLanes + lane];
        k.par[kPPBet * kL + threadIdx.x] =
            A.theta[(k.base + P[kBeOff]) * kLanes + lane];
      }
    }
    __syncthreads();
    if (L[kRelu]) {
      unsigned char* sg =
          A.signs ? A.signs + ((static_cast<long long>(step) * A.i[kM] + k.m) *
                                   A.i[kNBn] + zi) * B * kLanes + k.off
                  : nullptr;
      for (int e = threadIdx.x; e < B * kL; e += kT) {
        const int r = e / kL, c = e % kL;
        const float act = __fadd_rn(__fmul_rn(zh[e], k.par[kPGam * kL + c]),
                                    k.par[kPBet * kL + c]);
        if (sg) sg[r * kLanes + c] = act > 0.f;
        D[e] = __fmul_rn(D[e], act > 0.f ? 1.f : 0.f);
      }
      __syncthreads();
    }
    if (L[kGOff] >= 0) {
      lane_sums<4>(B, [&](int r, int c, float* val) {
        const float dv = D[r * kL + c], zv = zh[r * kL + c];
        const float dz = __fmul_rn(dv, k.par[kPGam * kL + c]);
        val[0] = __fmul_rn(dv, zv);
        val[1] = dv;
        val[2] = dz;
        val[3] = __fmul_rn(dz, zv);
      }, k);
      if (threadIdx.x < kL) {
        const int lane = k.off + threadIdx.x;
        A.g[(k.base + L[kGOff]) * kLanes + lane] = k.col[threadIdx.x];
        A.g[(k.base + L[kBeOff]) * kLanes + lane] = k.col[kL + threadIdx.x];
      }
      // the Linear bias gradient, the column sums of the new d, taken as
      // they are written: each thread's rows are lane_sums' partition
      float db = 0.f;
      for (int e = threadIdx.x; e < B * kL; e += kT) {
        const int c = e % kL;
        const float dz = __fmul_rn(D[e], k.par[kPGam * kL + c]);
        const float t =
            __fsub_rn(__fsub_rn(__fmul_rn(fB, dz), k.col[2 * kL + c]),
                      __fmul_rn(zh[e], k.col[3 * kL + c]));
        D[e] = __fmul_rn(__fdiv_rn(k.par[kPInv * kL + c], fB), t);
        db = __fadd_rn(db, D[e]);
      }
      k.red[threadIdx.x] = db;
      __syncthreads();
      if (threadIdx.x < kL) {
        float t = 0.f;
        for (int p = 0; p < kParts; ++p)
          t = __fadd_rn(t, k.red[p * kL + threadIdx.x]);
        A.g[(k.base + L[kBOff]) * kLanes + k.off + threadIdx.x] = t;
      }
    }
    STAMP(500 + 10 * li + 1);
    // d into every peer's Xd: the owners' lanes (all of them but for the
    // last block)
    if (owner) {
      for (int e = threadIdx.x; e < B * kQ; e += kT) {
        const int r = e / kQ, n0 = (e % kQ) * 4;
        put4<kBf16, kRes>(Xd,
                          static_cast<long long>(r) * kXSt<kBf16> + k.off + n0,
                          *reinterpret_cast<const float4*>(D + r * kL + n0));
      }
      broadcast<kBf16, kRes>(k, Xd, B);
    }
    // the block input a on the block's input lanes, as the forward saw it
    // after its dropout mask: x for the first block, else from the previous
    // block's x-hat
    const Mask mk = mask_of(A, step, k.m, L);
    const int K = L[kInRows];
    const int rows = min(kL, K - k.off);
    if (P) {
      const float* pz;
      if constexpr (kRes) {
        cp_wait_all();
        __syncthreads();
        pz = k.zring + static_cast<long long>((li - 1) & 1) * B * kL;
      } else {
        pz = k.zh + static_cast<long long>(P[kZhIdx]) * B * kL;
      }
      const bool prelu = P[kRelu] != 0;
      for (int e = threadIdx.x; e < B * kL; e += kT) {
        const int r = e / kL, c = e % kL;
        float a = __fadd_rn(__fmul_rn(pz[e], k.par[kPPGam * kL + c]),
                            k.par[kPPBet * kL + c]);
        if (prelu) a = fmaxf(a, 0.f);
        k.a[e] = masked(mk, a, r, k.off + c);
      }
    } else if (rows > 0) {
      const int in_pad = static_cast<int>(A.i[kInPad]);
      const float* x = A.xs + static_cast<long long>(step) * B * in_pad;
      for (int e = threadIdx.x; e < B * kL; e += kT) {
        const int r = e / kL, c = e % kL;
        k.a[e] = c < rows ? masked(mk, x[r * in_pad + k.off + c], r, k.off + c)
                          : 0.f;
      }
    }
    STAMP(500 + 10 * li + 2);
    exchange_sync<kRes>(cl);
    STAMP(500 + 10 * li + 3);
    // dW[own, :] = a[:, own]^T d over the lanes that carry d (the last
    // block's: those of the owners), into rows w_off + off.. of g
    const int nred = last ? k.out_blocks * kL : kLanes;
    if (rows > 0)
      atd<kBf16, kRes>(B, rows, nred, k.a, Xd,
                       A.g + (k.base + L[kWOff] + k.off) * kLanes);
    if (owner && L[kGOff] < 0) {   // the bias of a block without BatchNorm
      lane_sums<1>(B, [&](int r, int c, float* val) { val[0] = D[r * kL + c]; },
                   k);
      if (threadIdx.x < kL)
        A.g[(k.base + L[kBOff]) * kLanes + k.off + threadIdx.x] =
            k.col[threadIdx.x];
    }
    STAMP(500 + 10 * li + 4);
    if (li == 0) break;
    __syncthreads();
    // d = (d W^T) * mask on the block's input lanes
    dwt<kBf16, kRes>(B, nred, Xd, wr, D, mk, k.off);
    __syncthreads();
    STAMP(500 + 10 * li + 5);
    cl.sync();   // every peer is done reading Xd
    STAMP(500 + 10 * li + 6);
  }
}

// Each block's loss terms and sum of g^2 (of its columns of the member's
// slab, which every block's weight-gradient rows cross) into rank 0, which
// adds them in rank order: partials[m], and terms[m] (single sweep) or
// terms[0] (joint mean, member 0).
__device__ void cluster_reduce(const Args& A, const Blk& k, float term,
                               cg::cluster_group& cl) {
  // the weight gradients' rows come from every block of the cluster: fence
  // them, wait for every block, and read them past L1
  exchange_sync<false>(cl);
  const long long rows = A.i[kSlabRows];
  const float* gs = A.g + k.base * kLanes + k.off;
  float acc = 0.f;
#pragma unroll 4
  for (long long e = threadIdx.x; e < rows * kL; e += kT) {
    const float v = __ldcg(gs + (e / kL) * kLanes + e % kL);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  const float total = blk_sum(acc, k);
  if (threadIdx.x == 0) {
    k.out[0] = term;
    k.out[1] = total;
  }
  cl.sync();
  if (k.rank == 0 && threadIdx.x == 0) {
    float t = 0.f, p = 0.f;
    for (int q = 0; q < kC; ++q) {
      const float* o = cl.map_shared_rank(k.out, q);
      t = __fadd_rn(t, o[0]);
      p = __fadd_rn(p, o[1]);
    }
    A.partials[k.m] = p;
    if (A.i[kSingleSweep])
      A.terms[k.m] = t;
    else if (k.m == 0)
      A.terms[0] = t;
  }
  cl.sync();   // rank 0 has read every peer's values
}

// Joint mean only: every member's forward with the EMA; the owners of
// lanes below out_pad write the prediction's lanes to preds[m].
template <bool kBf16, bool kRes>
__global__ void __launch_bounds__(kT, 1)
    cluster_sweep_kernel(Args A, Layout lay, int step) {
  if (stopped(A)) return;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const Blk k = make_blk<kRes>(A, lay, smem, cl);
  STAMP_BEGIN(step == A.i[kS] / 2, 950);  // the middle step
  int s = 0;
  fetch_fwd(A, k, 0, k.ring);
  load_x<kBf16, kRes>(A, k, step, k.x0);
  exchange_sync<kRes>(cl);
  STAMP(951);
  cluster_forward<kBf16, kRes>(A, k, step, s, false, cl);
  if (k.rank < k.out_blocks) {
    const int B = static_cast<int>(A.i[kB]);
    float* pr = A.preds + static_cast<long long>(k.m) * B * kLanes + k.off;
    for (int e = threadIdx.x; e < B * kL; e += kT)
      pr[(e / kL) * kLanes + e % kL] = k.d[e];
  }
  STAMP_END();
}

// The member's step: its forward (single sweep) or the joint mean of the
// sweep's predictions, the loss, the backward into g, and the block sums
// for the optimizer.
template <bool kBf16, bool kRes>
__global__ void __launch_bounds__(kT, 1)
    cluster_step_kernel(Args A, Layout lay, int step) {
  if (stopped(A)) return;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const Blk k = make_blk<kRes>(A, lay, smem, cl);
  const int B = static_cast<int>(A.i[kB]);
  const int n = static_cast<int>(A.i[kNLins]);
  const bool owner = k.rank < k.out_blocks;
  STAMP_BEGIN(step == A.i[kS] / 2, 900);  // the middle step
  int s = 0;
  float term = 0.f;
  if (A.i[kSingleSweep]) {
    fetch_fwd(A, k, 0, k.ring);
    load_x<kBf16, kRes>(A, k, step, k.x0);
    exchange_sync<kRes>(cl);
    cluster_forward<kBf16, kRes>(A, k, step, s, true, cl);
    STAMP(901);
    if (owner) term = cluster_loss(A, k, step);
  } else {
    if (n >= 2) fetch_bwd(A, k, n - 1, k.ring);
    if (owner) {
      // the joint mean of every member's prediction on the block's lanes,
      // summed in member order; resident, the members' lanes are first
      // copied into the (still unused) exchange buffers, all at once
      const int M = static_cast<int>(A.i[kM]);
      const long long tile = static_cast<long long>(B) * kLanes;
      const bool staged =
          kRes && static_cast<long long>(M) * B * kL <= 2LL * B * kXS;
      if (staged) {
        for (int e = threadIdx.x; e < M * B * kQ; e += kT) {
          const int j = e / (B * kQ), b = (e / kQ) % B, q = e % kQ;
          cp16(k.x0 + (static_cast<long long>(j) * B + b) * kL + 4 * q,
               A.preds + j * tile + b * kLanes + k.off + 4 * q);
        }
        cp_commit();
        cp_wait_all();
        __syncthreads();
      }
      STAMP(901);
      for (int e = threadIdx.x; e < B * kL; e += kT) {
        const long long at = (e / kL) * kLanes + k.off + e % kL;
        float sum = staged ? k.x0[e] : A.preds[at];
        for (int j = 1; j < M; ++j)
          sum = __fadd_rn(
              sum, staged ? k.x0[static_cast<long long>(j) * B * kL + e]
                          : A.preds[j * tile + at]);
        k.d[e] = __fmul_rn(sum, A.f[kInvMembers]);
      }
      __syncthreads();
      STAMP(902);
      term = cluster_loss(A, k, step);
    }
  }
  STAMP(903);
  // every peer is done reading the forward's buffers (and has started)
  cl.sync();
  STAMP(904);
  cluster_backward<kBf16, kRes>(A, k, step, s, cl);
  STAMP(905);
  cluster_reduce(A, k, term, cl);
  STAMP_END();
}

inline cudaError_t launch_cluster(void (*kernel)(Args, Layout, int),
                                  const Args& A, const Layout& lay, int step,
                                  cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(A.i[kM] * kC));
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = static_cast<size_t>(lay.v[kLaySmemBytes]);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, A, lay, step);
}

inline cudaError_t prepare_kernel(void (*kernel)(Args, Layout, int),
                                  const Layout& lay) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(lay.v[kLaySmemBytes]));
}

template <bool kBf16, bool kRes>
int run_cluster_epoch_as(const Args& A, const Layout& lay, cudaStream_t st) {
  auto sweep = cluster_sweep_kernel<kBf16, kRes>;
  auto stepk = cluster_step_kernel<kBf16, kRes>;
  cudaError_t err = prepare_kernel(sweep, lay);
  if (err == cudaSuccess) err = prepare_kernel(stepk, lay);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = adam_blocks(A.i[kM] * A.i[kSlabRows] * kLanes);
  for (int step = 0; step < A.i[kS]; ++step) {
    if (!A.i[kSingleSweep]) err = launch_cluster(sweep, A, lay, step, st);
    if (err == cudaSuccess) err = launch_cluster(stepk, A, lay, step, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    adam_kernel<<<blocks, kOptThreads, 0, st>>>(A, step);
    if (step == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Run the S steps of the form on `st` with the layout `lay` (checked
// against the constants this file was compiled with); returns a
// cudaError_t (0 on success).
template <bool kBf16>
int run_cluster_epoch(const Args& A, const long long* layout,
                      cudaStream_t st) {
  Layout lay;
  for (int f = 0; f < kLayFields; ++f) lay.v[f] = layout[f];
  if (lay.v[kLayCluster] != kC || lay.v[kLayLanes] != kL ||
      lay.v[kLayThreads] != kT || lay.v[kLayXStride] != kXS ||
      lay.v[kLayWSlot] != kWSlot || lay.v[kLayOutBlocks] < 1 ||
      lay.v[kLayOutBlocks] > kC ||
      (A.i[kLoss] == kNll && lay.v[kLayOutBlocks] != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return lay.v[kLayResident] ? run_cluster_epoch_as<kBf16, true>(A, lay, st)
                             : run_cluster_epoch_as<kBf16, false>(A, lay, st);
}

}  // namespace
