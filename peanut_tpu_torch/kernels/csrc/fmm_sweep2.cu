// One directed second-order block sweep, one CUDA block per grid (sm_90a).
//
// Replaces the TPU kernel peanut_tpu/kernels/fmm_pallas.py::
// pallas_block_sweep2 (body _sweep2_kernel_batched, helpers _axis_ab,
// _godunov2, _pick_dir) together with its wrapper v_sweep2_pallas, which
// flips rows for the reverse direction.  Per row block, in sweep order:
// `inner` Jacobi passes of the divide-free, order-selecting Godunov update
// over 1- and 2-away neighbours; sources pinned to 0, walls to BIG.  The
// context rows are the previous block's two relaxed edge rows (carried) on
// the near side and the next block's two edge rows of the INPUT field
// (stale: before this sweep) on the far side.  Blocks tile the rows from
// row 0; the last may be ragged.  `reverse` sweeps the same blocks
// bottom-up with mirrored context, which equals the TPU wrapper's
// flip-after-padding (the direction choice is mirror-invariant).
//
// Design.  One block of NT threads per grid; the input and output fields in
// global memory (L2-resident), the current row block plus its four context
// rows in shared memory, double-buffered (Jacobi).  Input and output are
// separate buffers, so the far context always reads the stale input.  A
// thread owns a column and walks down the block with the column's five
// rows around the cell in registers.  Same operation order and arithmetic
// as the plain version (fmm.py::_order2_block): the three multiply-adds of
// _godunov2 round once (fma1), the other products are __fmul_rn so nvcc
// cannot contract them, and sqrtf is correctly rounded.  So the result
// equals the plain PyTorch version's on the card bit for bit.
//
// Bound (as chip_smoke.py counts it).  Bytes: read d (4 B) + wall + src
// (1 B each), write d (4 B): 16 x 482^2 x 10 B = 37 MB -> 11 us at
// 3.35 TB/s.  Work: inner passes of 70 operations per cell:
// 16 x 482^2 x 40 x 70 = 1.04e10 -> 0.155 ms at 67 TFLOP/s fp32.  The real
// limit is latency: ceil(482/16) = 31 dependent blocks x inner dependent
// passes behind a block-wide barrier, on 16 of 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;
constexpr float BIG = 0x1.2a05f2p+33f;         // fmm.py::BIG = 1e10
constexpr float HALF_BIG = 0x1.2a05f2p+32f;
constexpr float INV_15 = 0x1.555556p-1f;       // float32(2/3)
constexpr float INV_A_BOTH15 = 0x1.c71c72p-3f; // float32(1/4.5)
constexpr float INV_A_ONE15 = 0x1.3b13b2p-2f;  // float32(1/3.25)

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

struct AxisAB {
  float alpha, beta, inv;
  bool known;
};

__device__ __forceinline__ AxisAB axis_ab(float u1, float u2) {
  AxisAB r;
  r.known = u1 < HALF_BIG;
  bool use2 = r.known && (u2 < HALF_BIG) && (u2 <= u1);
  r.alpha = r.known ? (use2 ? 1.5f : 1.0f) : 0.0f;
  r.beta = r.known ? (use2 ? (__fmul_rn(4.0f, u1) - u2) * 0.5f : u1) : 0.0f;
  r.inv = use2 ? INV_15 : 1.0f;
  return r;
}

__device__ __forceinline__ float godunov2(float u1x, float u2x, float u1y,
                                          float u2y) {
  AxisAB x = axis_ab(u1x, u2x), y = axis_ab(u1y, u2y);
  float c1x = x.known ? (1.0f + x.beta) * x.inv : BIG;
  float c1y = y.known ? (1.0f + y.beta) * y.inv : BIG;
  float one_d = fminf(c1x, c1y);
  float A = __fmul_rn(x.alpha, x.alpha) + __fmul_rn(y.alpha, y.alpha);
  float B = fma1(x.alpha, x.beta, __fmul_rn(y.alpha, y.beta));
  float C = fma1(x.beta, x.beta, __fmul_rn(y.beta, y.beta)) - 1.0f;
  float disc = fma1(B, B, -__fmul_rn(A, C));
  bool xi = x.inv != 1.0f, yi = y.inv != 1.0f;
  float invA = (xi && yi) ? INV_A_BOTH15 : ((xi != yi) ? INV_A_ONE15 : 0.5f);
  float u2d = (B + sqrtf(fmaxf(disc, 0.0f))) * invA;
  bool ok = (disc >= 0.0f) && x.known && y.known &&
            (x.alpha * u2d >= x.beta) && (y.alpha * u2d >= y.beta);
  return fminf(ok ? u2d : one_d, BIG);
}

// Mirror-invariant upwind choice; writes the chosen (u1, u2).
__device__ __forceinline__ void pick_dir(float n1, float n2, float p1,
                                         float p2, float* u1, float* u2) {
  float eff_n = n2 <= n1 ? n2 : -BIG;
  float eff_p = p2 <= p1 ? p2 : -BIG;
  bool use_n = (n1 < p1) || ((n1 == p1) && (eff_n >= eff_p));
  *u1 = use_n ? n1 : p1;
  *u2 = use_n ? n2 : p2;
}

__global__ void __launch_bounds__(NT, 1)
block_sweep2_kernel(const float* __restrict__ d_in,
                    const uint8_t* __restrict__ wall,
                    const uint8_t* __restrict__ src,
                    float* __restrict__ d_out, int H, int W, int block,
                    int inner, int reverse) {
  extern __shared__ float smem[];
  const size_t plane = (size_t)H * W;
  const float* Din = d_in + blockIdx.x * plane;
  const uint8_t* wl_g = wall + blockIdx.x * plane;
  const uint8_t* sr_g = src + blockIdx.x * plane;
  float* Dout = d_out + blockIdx.x * plane;

  // ctx buffers: rows 0-1 top context, 2..2+R-1 the block, then 2 bottom
  const int ctx_rows = block + 4;
  float* ctx0 = smem;
  float* ctx1 = ctx0 + (size_t)ctx_rows * W;
  uint8_t* wl = reinterpret_cast<uint8_t*>(ctx1 + (size_t)ctx_rows * W);
  uint8_t* sr = wl + (size_t)block * W;

  const int nb = (H + block - 1) / block;
  for (int j = 0; j < nb; ++j) {
    const int k = reverse ? nb - 1 - j : j;
    const int r0 = k * block;
    const int R = imin(block, H - r0);
    const int n = R * W;
    // near context: the carry (top going down, bottom going up), written
    // by the previous block, BIG before the first; far context: the input
    // field's two rows beyond the block
    float* near_rows = ctx0 + (reverse ? (size_t)(2 + R) * W : 0);
    float* far_rows = ctx0 + (reverse ? 0 : (size_t)(2 + R) * W);
    if (j == 0)
      for (int e = threadIdx.x; e < 2 * W; e += NT) near_rows[e] = BIG;
    for (int e = threadIdx.x; e < n; e += NT) {
      size_t g = (size_t)r0 * W + e;
      ctx0[2 * W + e] = Din[g];
      wl[e] = wl_g[g];
      sr[e] = sr_g[g];
    }
    for (int e = threadIdx.x; e < 2 * W; e += NT) {
      int i = e / W, c = e - i * W;
      int row = reverse ? r0 - 2 + i : r0 + block + i;
      far_rows[e] = (row >= 0 && row < H) ? Din[(size_t)row * W + c] : BIG;
    }
    __syncthreads();
    // context rows are the same in both buffers
    for (int e = threadIdx.x; e < 2 * W; e += NT) {
      ctx1[e] = ctx0[e];
      ctx1[(size_t)(2 + R) * W + e] = ctx0[(size_t)(2 + R) * W + e];
    }
    __syncthreads();

    float* cur = ctx0;
    float* nxt = ctx1;
    for (int it = 0; it < inner; ++it) {
      // a thread per column, down the block's rows, the column's five
      // rows around the cell sliding in registers
      for (int c = threadIdx.x; c < W; c += NT) {
        float up2 = cur[c], up1 = cur[W + c], mid = cur[2 * W + c];
        float dn1 = cur[3 * W + c];
        for (int r = 0; r < R; ++r) {
          const int e = r * W + c;
          const float* row = cur + (size_t)(r + 2) * W;
          const float dn2 = row[c + 2 * W];
          float lf1 = c >= 1 ? row[c - 1] : BIG;
          float lf2 = c >= 2 ? row[c - 2] : BIG;
          float rt1 = c + 1 < W ? row[c + 1] : BIG;
          float rt2 = c + 2 < W ? row[c + 2] : BIG;
          float u1y, u2y, u1x, u2x;
          pick_dir(up1, up2, dn1, dn2, &u1y, &u2y);
          pick_dir(lf1, lf2, rt1, rt2, &u1x, &u2x);
          float cand = godunov2(u1x, u2x, u1y, u2y);
          float out = sr[e] ? 0.0f : fminf(mid, cand);
          nxt[(size_t)(r + 2) * W + c] = wl[e] ? BIG : out;
          up2 = up1; up1 = mid; mid = dn1; dn1 = dn2;
        }
      }
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }

    const float* res = cur + 2 * (size_t)W;
    for (int e = threadIdx.x; e < n; e += NT)
      Dout[(size_t)r0 * W + e] = res[e];
    if (j + 1 == nb) break;
    // carry for the next block: this block's two edge rows on the side the
    // sweep moves to (padded rows past H are BIG), staged in the free
    // buffer's first rows, then placed as the next block's near context
    for (int e = threadIdx.x; e < 2 * W; e += NT) {
      int i = e / W, c = e - i * W;
      int br = reverse ? i : R - 2 + i;      // row within this block
      nxt[e] = (br >= 0 && br < R) ? res[(size_t)br * W + c] : BIG;
    }
    __syncthreads();
    const int next_R = imin(block, H - (reverse ? k - 1 : k + 1) * block);
    float* next_near = ctx0 + (reverse ? (size_t)(2 + next_R) * W : 0);
    for (int e = threadIdx.x; e < 2 * W; e += NT) next_near[e] = nxt[e];
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t block_sweep2_smem_bytes(int W, int block) {
  return 2 * (size_t)(block + 4) * W * sizeof(float) + 2 * (size_t)block * W;
}

// (B, H, W) float32 field, uint8 wall/source masks -> (B, H, W) float32
// into d_out (which must not alias d_in).  Launches on `stream`; returns
// the cudaError_t of the launch.
extern "C" int block_sweep2_launch(const float* d_in, const uint8_t* wall,
                                   const uint8_t* src, float* d_out, int B,
                                   int H, int W, int block, int inner,
                                   int reverse, void* stream) {
  size_t smem = block_sweep2_smem_bytes(W, block);
  cudaError_t err = cudaFuncSetAttribute(
      block_sweep2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_sweep2_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      d_in, wall, src, d_out, H, W, block, inner, reverse);
  return (int)cudaGetLastError();
}
