// Per-ROI window pooling for ROIAlign, one CUDA block per (ROI, 64-channel
// tile) (sm_90a).
//
// Replaces the TPU kernel peanut_tpu/kernels/roi_window.py::roi_window_pool
// (bodies _kernel1 and _kernel).  For ROI i it computes
//     out[i] = A_y[i] @ W_i @ A_x[i]^T        (p_y, p_x, C) float32,
// where W_i = flat[row0[i] : row0[i] + win_y, col0[i] : col0[i] + win_x, :]
// is a window of the stacked pyramid buffer and A_y, A_x are the bilinear
// hat matrices of the ROI's samples.  Not divided by the sample count: the
// caller divides.  Numerics as the TPU kernel and the JAX gather path have
// them: A_y is rounded to the feature type (bf16 when serving) before it
// meets W; A_x and all sums stay float32.
//
// Design.  Window cells outside the buffer read as zero (cp.async zero-fill),
// so the caller needs no padded copy of the buffer and no aligned origin.
// A block first loads its ROI's hat matrices into shared memory and finds
// the rows and columns that carry a nonzero weight: the rest of the window
// adds exact zeros, so only that support is read.  It then streams the
// window's support rows through shared memory, double-buffered with cp.async
// (64 channels x the support's columns per row), and contracts each row as
// it lands: warp q (one per output column p_x = q) forms
//     u[c] = sum_w A_x[q, w] * W[r, w, c]
// for its lane's two channels and folds it into the p_y accumulators,
//     acc[p_y][c] += A_y[p_y, r] * u[c],
// all in float32 FMAs.  Contracting x before y is the same sum in another
// association; it needs p accumulators a thread and no (p, win_x, C)
// intermediate, which would not fit shared memory for the 274-column
// x-elongated window.
//
// Bound (as chip_smoke.py counts it): bytes = the distinct buffer cells the
// windows' supports cover, once, + hat matrices + the float32 output, at
// 3.35 TB/s; operations = 2 C p R X + 2 C p^2 min(R, X) per ROI over its
// R x X support, at 67 TFLOP/s float32 (no tensor cores in this version).
// At the serving shapes the output write (n p^2 C float32) dominates, so
// the bound is bytes; windows overlap (the same cells serve many ROIs), so
// the reads come mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 64;  // channels per block: 32 lanes x 2

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two adjacent channels of a window row in shared memory, as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A_y rounded to the feature type, as the TPU kernel's ay.astype(w.dtype)
template <typename T>
__device__ __forceinline__ float hat_round(float v);
template <>
__device__ __forceinline__ float hat_round<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float hat_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int P>
__global__ void __launch_bounds__(32 * P)
    roi_window_kernel(const T* __restrict__ flat, const float* __restrict__ ay,
                      const float* __restrict__ ax,
                      const int* __restrict__ row0,
                      const int* __restrict__ col0, float* __restrict__ out,
                      int Hs, int Ws, int C, int win_y, int win_x) {
  constexpr int NT = 32 * P;
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte chunk
  constexpr int CPC = CT / EPC;             // chunks per column of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range[4];

  const int roi = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int px = tid >> 5;

  T* rows = reinterpret_cast<T*>(smem_raw);                 // 2 x win_x x CT
  float* s_ay = reinterpret_cast<float*>(rows + 2 * (size_t)win_x * CT);
  float* s_ax = s_ay + P * win_y;                           // P x win_x

  const float* g_ay = ay + (size_t)roi * P * win_y;
  const float* g_ax = ax + (size_t)roi * P * win_x;
  if (tid == 0) {
    range[0] = win_y; range[1] = -1; range[2] = win_x; range[3] = -1;
  }
  __syncthreads();
  int lo = win_y, hi = -1;
  for (int r = tid; r < win_y; r += NT) {
    bool nz = false;
    for (int q = 0; q < P; ++q) {
      float v = hat_round<T>(g_ay[q * win_y + r]);
      s_ay[q * win_y + r] = v;
      nz |= v != 0.0f;
    }
    if (nz) { lo = min(lo, r); hi = max(hi, r); }
  }
  if (hi >= 0) { atomicMin(&range[0], lo); atomicMax(&range[1], hi); }
  lo = win_x; hi = -1;
  for (int w = tid; w < win_x; w += NT) {
    bool nz = false;
    for (int q = 0; q < P; ++q) {
      float v = g_ax[q * win_x + w];
      s_ax[q * win_x + w] = v;
      nz |= v != 0.0f;
    }
    if (nz) { lo = min(lo, w); hi = max(hi, w); }
  }
  if (hi >= 0) { atomicMin(&range[2], lo); atomicMax(&range[3], hi); }
  __syncthreads();
  const int ry0 = range[0], ry1 = range[1] + 1;
  const int cx0 = range[2], cx1 = range[3] + 1;

  float acc0[P], acc1[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc0[q] = acc1[q] = 0.0f;

  if (ry1 > ry0 && cx1 > cx0) {
    const int ncol = cx1 - cx0;
    const int gr0 = row0[roi], gc0 = col0[roi] + cx0;
    // one support row of the window into buffer `buf`; cells outside the
    // buffer (and channels past C) are zero-filled
    auto load_row = [&](int r, int buf) {
      T* dst = rows + (size_t)buf * win_x * CT;
      const int gr = gr0 + r;
      const bool row_ok = gr >= 0 && gr < Hs;
      for (int e = tid; e < ncol * CPC; e += NT) {
        const int w = e / CPC, k = e - w * CPC;
        const int gc = gc0 + w, ch = c0 + k * EPC;
        const bool ok = row_ok && gc >= 0 && gc < Ws && ch < C;
        const T* src = ok ? flat + ((size_t)gr * Ws + gc) * C + ch : flat;
        cp_async16(dst + (size_t)w * CT + k * EPC, src, ok ? 16 : 0);
      }
      cp_async_commit();
    };
    load_row(ry0, 0);
    for (int r = ry0; r < ry1; ++r) {
      const int buf = (r - ry0) & 1;
      if (r + 1 < ry1) {
        load_row(r + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* row = rows + (size_t)buf * win_x * CT + 2 * lane;
      const float* axq = s_ax + px * win_x + cx0;
      float u0 = 0.0f, u1 = 0.0f;
      for (int w = 0; w < ncol; ++w) {
        const float2 v = load2(row + (size_t)w * CT);
        const float a = axq[w];
        u0 = fmaf(a, v.x, u0);
        u1 = fmaf(a, v.y, u1);
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float wy = s_ay[q * win_y + r];
        acc0[q] = fmaf(wy, u0, acc0[q]);
        acc1[q] = fmaf(wy, u1, acc1[q]);
      }
      __syncthreads();  // the buffer is refilled two rows on
    }
  }

  const int c = c0 + 2 * lane;
  if (c < C) {
    float* o = out + (size_t)roi * P * P * C + (size_t)px * C + c;
#pragma unroll
    for (int q = 0; q < P; ++q)
      *reinterpret_cast<float2*>(o + (size_t)q * P * C) =
          make_float2(acc0[q], acc1[q]);
  }
}

template <typename T, int P>
int launch(const void* flat, const float* ay, const float* ax,
           const int* row0, const int* col0, float* out, int n, int Hs,
           int Ws, int C, int win_y, int win_x, size_t smem,
           cudaStream_t stream) {
  auto kern = roi_window_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n, (C + CT - 1) / CT);
  kern<<<grid, 32 * P, smem, stream>>>(static_cast<const T*>(flat), ay, ax,
                                       row0, col0, out, Hs, Ws, C, win_y,
                                       win_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t roi_window_smem_bytes(int is_bf16, int p, int win_y,
                                        int win_x) {
  return 2 * (size_t)win_x * CT * (is_bf16 ? 2 : 4) +
         sizeof(float) * (size_t)p * (win_y + win_x);
}

// The pooled sizes the kernel is built for, Mask R-CNN's box and mask heads
// (p is a template parameter: the p_y accumulators live in registers).
extern "C" int roi_window_supports_p(int p) { return p == 7 || p == 14; }

// flat: (Hs, Ws, C) float32 (is_bf16 = 0) or bfloat16 (1), contiguous, C a
// multiple of 8; ay (n, p, win_y), ax (n, p, win_x) float32; row0, col0 (n,)
// int32 window origins (any value: out-of-buffer cells read as zero);
// out (n, p, p, C) float32.  Launches on `stream`; returns the cudaError_t.
extern "C" int roi_window_pool_launch(const void* flat, int is_bf16,
                                      const float* ay, const float* ax,
                                      const int* row0, const int* col0,
                                      float* out, int n, int p, int Hs,
                                      int Ws, int C, int win_y, int win_x,
                                      void* stream) {
  const size_t smem = roi_window_smem_bytes(is_bf16, p, win_y, win_x);
  cudaStream_t s = (cudaStream_t)stream;
#define ROI_CASE(T, P)                                                     \
  return launch<T, P>(flat, ay, ax, row0, col0, out, n, Hs, Ws, C, win_y, \
                      win_x, smem, s)
  if (is_bf16) {
    switch (p) {
      case 7: ROI_CASE(__nv_bfloat16, 7);
      case 14: ROI_CASE(__nv_bfloat16, 14);
    }
  } else {
    switch (p) {
      case 7: ROI_CASE(float, 7);
      case 14: ROI_CASE(float, 14);
    }
  }
#undef ROI_CASE
  return (int)cudaErrorInvalidValue;
}
