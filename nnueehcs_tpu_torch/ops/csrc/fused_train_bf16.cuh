// The bf16-mixed form of the training kernel's block GEMM (kernel 3's bf16
// form): the overload of fused_train.cuh's block_gemm for SmemBf16, with the
// same strided-operand interface, so fused_train.cuh's member forward and
// backward run on it unchanged.
//
// Function: the JAX kernel's mm() under plan.bf16, both operands rounded to
// bf16 (round to nearest even, the JAX astype) and their exact products
// summed in fp32; the result (and the bias added to it) is fp32, as the fp32
// form writes it.
//
// Layout: each 128-row output tile is computed by 16 warps, each a 32-row by
// 32-column slice (2 x 4 mma.sync.m16n8k16 tiles, 32 fp32 accumulators a
// thread). Both operands are staged from fp32 into shared memory 32
// reduction steps at a time, rounded to bf16 there, each in its own major so
// the global reads walk the contiguous stride:
// - A (rows x K) with k contiguous is kept as [row][k] and read by ldmatrix;
//   with rows contiguous (a^T of an activation in the weight gradient) as
//   [k][row] and read by ldmatrix.trans;
// - B (K x 128) with n contiguous (W in the forward, d in the weight
//   gradient) is kept as [k][n] and read by ldmatrix.trans; with k
//   contiguous (W^T in the input gradient) as [n][k], read by ldmatrix.
// Rows and reduction steps past the operands' ends are staged as zeros. The
// +8 bf16 pad of every shared row puts the 8 rows an ldmatrix reads on
// distinct 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>

#include "fused_chain_bf16.cuh"
#include "fused_train.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct SmemBf16 {
  union {
    bf16 rm[kTile][kK + 8];    // A(r, k) at rm[r][k]
    bf16 cm[kK][kTile + 8];    // A(r, k) at cm[k][r]
  } a;
  union {
    bf16 kn[kK][kLanes + 8];   // B(k, n) at kn[k][n]
    bf16 nk[kLanes][kK + 8];   // B(k, n) at nk[n][k]
  } b;
  float red[4][4][kLanes];     // as Smem: col_sums, block_sum
  float col[4][kLanes];
  float warp[kThreads / 32];
};

// c (rows x 128, row stride 128) = bf16(A) (rows x K) * bf16(Bm) (K x 128)
// (+ bias), with fp32 accumulation; operands and kSq as fused_train.cuh's
// block_gemm.
template <bool kSq = false, class... Sq>
__device__ void block_gemm(int rows, int K, const float* a, long long a_rs,
                           long long a_ks, const float* b, long long b_ks,
                           long long b_cs, const float* bias, float* c,
                           SmemBf16& sm, Sq&... sq) {
  using fused_chain_bf16::ldmatrix_x4;
  using fused_chain_bf16::ldmatrix_x4_trans;
  using fused_chain_bf16::mma;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp >> 2) * 32;   // the warp's first row of the tile
  const int wc = (warp & 3) * 32;    // and first column
  const bool a_kmaj = a_ks == 1;
  const bool b_nmaj = b_cs == 1;
  for (int r0 = 0; r0 < rows; r0 += kTile) {
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kK) {
      for (int e = tid; e < kTile * kK; e += kThreads) {
        int r, kk;
        if (a_kmaj) {
          r = e / kK;
          kk = e % kK;
        } else {
          kk = e / kTile;
          r = e % kTile;
        }
        const int gr = r0 + r, gk = k0 + kk;
        const bf16 v = __float2bfloat16_rn(
            (gr < rows && gk < K) ? a[gr * a_rs + gk * a_ks] : 0.f);
        if (a_kmaj)
          sm.a.rm[r][kk] = v;
        else
          sm.a.cm[kk][r] = v;
      }
      for (int e = tid; e < kLanes * kK; e += kThreads) {
        int n, kk;
        if (b_nmaj) {
          kk = e / kLanes;
          n = e % kLanes;
        } else {
          n = e / kK;
          kk = e % kK;
        }
        const int gk = k0 + kk;
        const bf16 v = __float2bfloat16_rn(gk < K ? b[gk * b_ks + n * b_cs]
                                                  : 0.f);
        if (b_nmaj)
          sm.b.kn[kk][n] = v;
        else
          sm.b.nk[n][kk] = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kK; ks += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m0 = wr + mt * 16;
          if (a_kmaj)
            ldmatrix_x4(af[mt], &sm.a.rm[m0 + (lane & 15)][ks + (lane >> 4) * 8]);
          else
            ldmatrix_x4_trans(af[mt], &sm.a.cm[ks + (lane & 7) + ((lane >> 4) << 3)]
                                              [m0 + ((lane >> 3) & 1) * 8]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int n0 = wc + np * 16;
          uint32_t bq[4];
          if (b_nmaj)
            ldmatrix_x4_trans(bq, &sm.b.kn[ks + (lane & 15)][n0 + (lane >> 4) * 8]);
          else
            ldmatrix_x4(bq, &sm.b.nk[n0 + (lane & 7) + ((lane >> 4) << 3)]
                                    [ks + ((lane >> 3) & 1) * 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(acc[mt][2 * np], af[mt], bq[0], bq[1]);
            mma(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
          }
        }
      }
      __syncthreads();
    }
    // accumulator e of tile (mt, nt): row g (+8 for e >= 2), column 2q (+1
    // for odd e) of the tile
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wr + mt * 16 + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = wc + nt * 8 + 2 * q + j;
            const float acc_v = acc[mt][nt][2 * h + j];
            const float v = bias ? __fadd_rn(acc_v, bias[n]) : acc_v;
            c[static_cast<long long>(r) * kLanes + n] = v;
            if constexpr (kSq) ((sq = __fadd_rn(sq, __fmul_rn(v, v))), ...);
          }
      }
  }
  __syncthreads();
}

// The production step's kernels in bf16-mixed: fused_train.cuh's bodies on
// SmemBf16; the optimizer (adam_kernel) has no product and is shared.
__global__ void __launch_bounds__(kThreads, 1)
    loss_sweep_bf16_kernel(Args A, int step) {
  __shared__ __align__(16) SmemBf16 sm;
  loss_sweep(A, step, sm);
}

__global__ void __launch_bounds__(kThreads, 1)
    member_step_bf16_kernel(Args A, int step) {
  __shared__ __align__(16) SmemBf16 sm;
  member_step(A, step, sm);
}

}  // namespace
