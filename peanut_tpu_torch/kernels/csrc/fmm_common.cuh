// First-order eikonal block relaxation shared by the fused solve
// (fmm_fused.cu, B1) and the directed block sweep (fmm_sweep.cu, B4).
//
// relax_block relaxes one row block against its two boundary rows:
// inner/scan_chunk rounds of { both segmented row min-plus scans, a warp per
// row held in registers; scan_chunk Jacobi Godunov stencil passes, a thread
// per column, double-buffered in shared memory }.  The arithmetic is the
// plain version's (fmm.py::_RowScan, _Stencil, _godunov): the same
// Hillis-Steele association, the one multiply-add of the update rounded once
// (fma1), a correctly rounded sqrtf and nothing else that can contract, so
// a kernel built from it equals its plain PyTorch version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 BIG = 1e10 and 0.5 * BIG (fmm.py::BIG)
constexpr float BIG = 0x1.2a05f2p+33f;
constexpr float HALF_BIG = 0x1.2a05f2p+32f;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// float32 a * b + c rounded once: the FMA that XLA's CPU backend contracts
// and the plain version reproduces through float64 (fmm.py::_fma).  The
// two agree unless the float64 sum is inexact and lands exactly on a
// float32 rounding midpoint, which the neighbouring-magnitude operands of
// these updates do not produce (the kernels check out bit-equal to the
// plain versions).  A hardware FMA, where float64 costs 5 instructions.
__device__ __forceinline__ float fma1(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ float godunov(float a, float b) {
  float diff = a - b;
  float direct = fminf(a, b) + 1.0f;
  float disc = sqrtf(fmaxf(fma1(-diff, diff, 2.0f), 0.0f));
  float both = 0.5f * ((a + b) + disc);
  return fabsf(diff) >= 1.0f ? direct : both;
}

// One forward (reverse) Hillis-Steele step of shift S over a row held in
// registers by one warp: lane l owns cells c = l + 32 k, k < KW.  Cells
// before the start (after the end, or past W) are (0, BIG).  Shifts below
// 32 read other lanes through shuffles, larger ones other registers of the
// same lane.  The arithmetic is the plain version's (fmm.py::_RowScan).
template <int KW, int S, bool REVERSE>
__device__ __forceinline__ void hs_step(float (&a)[KW], float (&b)[KW],
                                        int lane) {
  if constexpr (S < 32) {
    const unsigned full = 0xffffffffu;
    const int src = REVERSE ? (lane + S) & 31 : (lane - S) & 31;
    const bool same_k = REVERSE ? lane + S < 32 : lane >= S;
    float sa[KW], sb[KW];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      sa[k] = __shfl_sync(full, a[k], src);
      sb[k] = __shfl_sync(full, b[k], src);
    }
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int kn = REVERSE ? k + 1 : k - 1;   // the other lane's register
      const bool kn_ok = REVERSE ? kn < KW : kn >= 0;
      float a_n = same_k ? sa[k] : (kn_ok ? sa[REVERSE ? (k + 1) % KW
                                                        : (k + KW - 1) % KW]
                                          : 0.0f);
      float b_n = same_k ? sb[k] : (kn_ok ? sb[REVERSE ? (k + 1) % KW
                                                        : (k + KW - 1) % KW]
                                          : BIG);
      b[k] = fminf(b[k], b_n + a[k]);
      a[k] = fminf(a_n + a[k], BIG);
    }
  } else {
    constexpr int M = S / 32;
    // update in the order that reads every neighbour before it changes
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = REVERSE ? i : KW - 1 - i;
      const int kn = REVERSE ? k + M : k - M;
      const bool ok = REVERSE ? kn < KW : kn >= 0;
      float a_n = ok ? a[ok ? kn : 0] : 0.0f;
      float b_n = ok ? b[ok ? kn : 0] : BIG;
      b[k] = fminf(b[k], b_n + a[k]);
      a[k] = fminf(a_n + a[k], BIG);
    }
  }
}

template <int KW, bool REVERSE>
__device__ __forceinline__ void hs_row(float (&a)[KW], float (&b)[KW],
                                       int lane) {
  hs_step<KW, 1, REVERSE>(a, b, lane);
  hs_step<KW, 2, REVERSE>(a, b, lane);
  hs_step<KW, 4, REVERSE>(a, b, lane);
  hs_step<KW, 8, REVERSE>(a, b, lane);
  hs_step<KW, 16, REVERSE>(a, b, lane);
  hs_step<KW, 32, REVERSE>(a, b, lane);
  hs_step<KW, 64, REVERSE>(a, b, lane);
  hs_step<KW, 128, REVERSE>(a, b, lane);
  hs_step<KW, 256, REVERSE>(a, b, lane);
  if constexpr (KW > 16) hs_step<KW, 512, REVERSE>(a, b, lane);
}

// Both row scans of one row, in place on `row`, by one warp, in registers
// (W <= 32 * KW).  Steps with shifts >= W change nothing, so running all
// log2(32 * KW) of them equals the plain version's `while s < n` loop.
template <int KW>
__device__ void warp_row_scans(float* row, const uint8_t* wrow, int W) {
  const int lane = threadIdx.x & 31;
  for (int dir = 0; dir < 2; ++dir) {
    float a[KW], b[KW];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int c = lane + 32 * k;
      const bool real = c < W;
      const bool w = real && wrow[c];
      a[k] = real ? (w ? BIG : 1.0f) : 0.0f;
      b[k] = real ? (w ? BIG : row[c]) : BIG;
    }
    if (dir == 0)
      hs_row<KW, false>(a, b, lane);
    else
      hs_row<KW, true>(a, b, lane);
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int c = lane + 32 * k;
      if (c < W) row[c] = fminf(row[c], b[k]);
    }
    __syncwarp();
  }
}

// Relax one block (R rows of W cells, walls wl) against boundary rows
// top/bottom with NT threads; returns the buffer that holds the result
// (cur or nxt).
template <int NT, int KW>
__device__ float* relax_block(float* cur, float* nxt, const uint8_t* wl,
                              const float* top, const float* bottom, int R,
                              int W, int inner, int scan_chunk) {
  for (int it = 0; it < inner / scan_chunk; ++it) {
    // a warp per row
    for (int r = threadIdx.x / 32; r < R; r += NT / 32)
      warp_row_scans<KW>(cur + (size_t)r * W, wl + (size_t)r * W, W);
    __syncthreads();
    for (int p = 0; p < scan_chunk; ++p) {
      // a thread per column, down the block's rows
      for (int c = threadIdx.x; c < W; c += NT) {
        for (int r = 0; r < R; ++r) {
          int e = r * W + c;
          float up = r > 0 ? cur[e - W] : top[c];
          float down = r < R - 1 ? cur[e + W] : bottom[c];
          float left = c > 0 ? cur[e - 1] : BIG;
          float right = c < W - 1 ? cur[e + 1] : BIG;
          float cand = godunov(fminf(up, down), fminf(left, right));
          nxt[e] = wl[e] ? BIG : fminf(cur[e], cand);
        }
      }
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
  }
  return cur;
}

}  // namespace
