// Per-ROI window pooling for ROIAlign, one CUDA block per (ROI, channel
// tile) (sm_90a); bf16 on the tensor cores.
//
// Replaces the TPU kernel peanut_tpu/kernels/roi_window.py::roi_window_pool
// (bodies _kernel1 and _kernel, contraction _contract).  For ROI i it
// computes
//     out[i] = A_y[i] @ W_i @ A_x[i]^T        (p_y, p_x, C) float32,
// where W_i = flat[row0[i] : row0[i] + win_y, col0[i] : col0[i] + win_x, :]
// is a window of the stacked pyramid buffer and A_y, A_x are the bilinear
// hat matrices of the ROI's samples.  Not divided by the sample count: the
// caller divides.  Numerics as the TPU kernel and the JAX gather path have
// them: A_y is rounded to the feature type (bf16 when serving) before it
// meets W; A_x and all sums stay float32.
//
// Design.  Only the support is read: the rows and columns whose hat weight
// is nonzero (the rest adds exact zeros).  Window cells outside the buffer
// read as zero (cp.async zero-fill): the caller needs no padded copy and no
// aligned origin.
//   bf16 (serving), two kernels, in the TPU kernel's order: y first,
// t[p_y, x, c] = sum_r A_y[p_y, r] W[r, x, c], then out[p_y, p_x, c] =
// sum_x A_x[p_x, x] t[p_y, x, c].  roi_prep, a block per ROI, finds the
// support once and writes the ROI's record: the support, A_y's support rows
// rounded to bf16, A_x's support columns transposed.  roi_pool_bf16, a
// block of WARPS warps per (ROI, 16 WARPS channels), copies the record into
// shared memory; then every warp runs alone on its own 16 channels and
// streams them through its own ring of NSTAGE stages (two in flight while
// one is contracted), XC window columns of all R16 support rows (R rounded
// up to 16) a stage, XC = max(R16max, ring_rows) / R16 (the launch's
// RING_ROWS): no block barrier in the loop, only
// a stage's cp.async completion and a __syncwarp.  The y-contraction is a
// product of bf16 operands with float32 sums, exact products on the tensor
// cores: mma.sync.m16n8k16, M = 16 channels, N = 8 p_y (p = 7 pads to 8,
// 14 takes two tiles), K = 16 support rows, two window columns at a time
// (two independent chains).  A = W^T comes from the stage by
// ldmatrix.trans (a stage row is 16 channels at (x, r), its two 16-byte
// chunks swapped on rows 4-7 of every 8 so the 8 rows of a matrix hit 8
// bank groups); B = A_y^T from the record.  The fragment's t values (2
// channels x 2 p_y a lane and tile) go at once into the x-contraction,
// acc[p_x] += A_x[p_x, x] * t, float32 FMAs on CUDA cores (A_x is float32,
// unrounded), A_x's column read as float4s.  The output goes through
// shared memory once, as 16-byte stores of whole rows of the warp's
// channels.
//   float32 (single-nav's batch-1 first detect): CUDA cores, one kernel,
// x first (roi_pool_f32).
//
// Bound (as chip_smoke.py counts it): bytes = the distinct buffer cells the
// windows' supports cover, once, + hat matrices + the float32 output, at
// 3.35 TB/s; operations = 2 C p R X (y, at the bf16 tensor-core peak of
// 989 TFLOP/s when serving, else 67 TFLOP/s float32) + 2 C p^2 X (x, 67
// TFLOP/s float32) per ROI over its R x X support.  At the serving shapes
// the output write (n p^2 C float32) is most of the bytes; windows overlap
// (the same cells serve many ROIs), so the reads come mostly from L2.
//
// The kernels' PART splits a launch's time for chip_smoke.py's breakdown:
// 1 writes the output alone (hats and support, no window loads, no
// contraction), 2 adds the window loads; the pool is PART 0.  Only
// roi_window_pool_part_launch instantiates 1 and 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NSTAGE = 3;
constexpr int WARPS = 4;    // bf16: warps (16 channels each) a block
// bf16: rows of a ring stage (chip_smoke.py's kernel_breakdown times 32-512
// through roi_window_pool_part_launch; 64 is the fastest or within 4 % of
// it at the detect's four window shapes)
constexpr int RING_ROWS = 64;

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// d += a b: m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A_y rounded to bf16, as the TPU kernel's ay.astype(w.dtype)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

// The bf16 kernels' p_y (p_x) tiles of 8 for pooled size P.
template <int P>
struct Cfg {
  static constexpr int NTP = (P + 7) / 8;         // 8-wide p_y (p_x) tiles
  static constexpr int PP = 8 * NTP;              // p_y, p_x padded
};

// Shared memory of roi_prep, in this order: A_y rounded, float32
// [P][win_y], A_x transposed [win_x][PP], A_y's support rows for the
// contraction, bf16 [PP][R16max + 8].
struct Smem {
  size_t ay, axt, ayc, total;
};

template <int P>
__host__ __device__ inline Smem prep_layout(int win_y, int win_x) {
  using K = Cfg<P>;
  Smem s;
  s.ay = 0;
  s.axt = up16(s.ay + (size_t)P * win_y * 4);
  s.ayc = up16(s.axt + (size_t)win_x * K::PP * 4);
  s.total = up16(s.ayc + (size_t)K::PP * (round16(win_y) + 8) * 2);
  return s;
}

// bf16: a stage holds XC = cap / R16 window columns of R16 support rows,
// at least one column: cap = max(R16max, ring_rows)
__host__ __device__ inline int ring_cap(int win_y, int ring_rows) {
  const int r16 = round16(win_y);
  return r16 > ring_rows ? r16 : ring_rows;
}

struct Support {
  int ry0, R, cx0, X, R16, gr0, gc0;
};

// roi_prep's start: the ROI's hat matrices into shared memory (A_y
// rounded, A_x transposed and padded to PP), their support, and A_y's
// support rows in the contraction's layout, zero past R and P.  One round
// of global loads (the origins with them).
template <int P, int NT>
__device__ __forceinline__ Support load_hats(
    const float* __restrict__ ay, const float* __restrict__ ax,
    const int* __restrict__ row0, const int* __restrict__ col0, int roi,
    int win_y, int win_x, const Smem& L, unsigned char* smem, int* range) {
  using K = Cfg<P>;
  const int tid = threadIdx.x;
  float* s_ay = reinterpret_cast<float*>(smem + L.ay);
  float* s_axt = reinterpret_cast<float*>(smem + L.axt);
  const int r_org = row0[roi], c_org = col0[roi];
  if (tid == 0) {
    range[0] = win_y; range[1] = -1; range[2] = win_x; range[3] = -1;
  }
  for (int e = tid; e < (K::PP - P) * win_x; e += NT) {
    const int x = e / (K::PP - P);
    s_axt[x * K::PP + P + (e - x * (K::PP - P))] = 0.0f;
  }
  __syncthreads();
  const float* g_ay = ay + (size_t)roi * P * win_y;
  const float* g_ax = ax + (size_t)roi * P * win_x;
  const int ny = P * win_y, nall = ny + P * win_x;
  int ylo = win_y, yhi = -1, xlo = win_x, xhi = -1;
#pragma unroll 4
  for (int e = tid; e < nall; e += NT) {
    if (e < ny) {
      const float v = round_bf16(g_ay[e]);
      s_ay[e] = v;
      const int r = e % win_y;
      if (v != 0.0f) { ylo = min(ylo, r); yhi = max(yhi, r); }
    } else {
      const int f = e - ny, q = f / win_x, x = f - q * win_x;
      const float v = g_ax[f];
      s_axt[x * K::PP + q] = v;
      if (v != 0.0f) { xlo = min(xlo, x); xhi = max(xhi, x); }
    }
  }
  if (yhi >= 0) { atomicMin(&range[0], ylo); atomicMax(&range[1], yhi); }
  if (xhi >= 0) { atomicMin(&range[2], xlo); atomicMax(&range[3], xhi); }
  __syncthreads();
  Support sp;
  sp.ry0 = range[0];
  sp.R = range[1] + 1 - sp.ry0;
  sp.cx0 = range[2];
  sp.X = range[3] + 1 - sp.cx0;
  sp.R16 = round16(sp.R > 0 ? sp.R : 0);
  sp.gr0 = r_org + sp.ry0;
  sp.gc0 = c_org + sp.cx0;
  __nv_bfloat16* ayb = reinterpret_cast<__nv_bfloat16*>(smem + L.ayc);
  const int AYP = round16(win_y) + 8;
  for (int e = tid; e < K::PP * sp.R16; e += NT) {
    const int q = e / sp.R16, r = e - q * sp.R16;
    ayb[q * AYP + r] = __float2bfloat16_rn(
        q < P && r < sp.R ? s_ay[q * win_y + sp.ry0 + r] : 0.0f);
  }
  __syncthreads();
  return sp;
}

// The bf16 path's per-ROI record, written by roi_prep and read whole by
// every block of the ROI: a header (support and origin), A_y's support
// rows as bf16 [PP][AYP] (AYP = R16max + 8, zero past R and P), A_x's
// support columns transposed, float32 [X][PP] (zero past P).
struct Rec {
  int ayb, axt, bytes;
};

template <int P>
__host__ __device__ inline Rec rec_layout(int win_y, int win_x) {
  using K = Cfg<P>;
  Rec r;
  r.ayb = 32;
  r.axt = (int)up16(r.ayb + (size_t)K::PP * (round16(win_y) + 8) * 2);
  r.bytes = (int)up16(r.axt + (size_t)win_x * K::PP * 4);
  return r;
}

// The main kernel's shared memory: each warp's ring (NSTAGE stages of cap
// rows of 16 channels, also its output tile), then the ROI's record.
struct Bf16Smem {
  size_t warp, rec, total;
  int cap;
};

template <int P>
__host__ __device__ inline Bf16Smem bf16_smem(int win_y, int win_x,
                                              int ring_rows) {
  Bf16Smem s;
  s.cap = ring_cap(win_y, ring_rows);
  const size_t stages = (size_t)NSTAGE * s.cap * 32;
  const size_t tile = (size_t)P * P * 16 * 4;
  s.warp = stages > tile ? stages : tile;
  s.rec = s.warp * WARPS;
  s.total = s.rec + rec_layout<P>(win_y, win_x).bytes;
  return s;
}

// bf16, first kernel: a block per ROI computes its record from the hat
// matrices once (load_hats), for every block that pools the ROI.
template <int P>
__global__ void __launch_bounds__(128)
    roi_prep(const float* __restrict__ ay, const float* __restrict__ ax,
             const int* __restrict__ row0, const int* __restrict__ col0,
             unsigned char* __restrict__ recs, int win_y, int win_x) {
  using K = Cfg<P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range[4];
  const Smem L = prep_layout<P>(win_y, win_x);
  const int roi = blockIdx.x;
  const Support sp = load_hats<P, 128>(ay, ax, row0, col0, roi, win_y,
                                       win_x, L, smem_raw, range);
  const Rec RL = rec_layout<P>(win_y, win_x);
  unsigned char* rec = recs + (size_t)roi * RL.bytes;
  const int tid = threadIdx.x;
  if (tid < 8) {
    const int h[8] = {sp.ry0, sp.R, sp.cx0, sp.X, sp.R16, sp.gr0, sp.gc0, 0};
    reinterpret_cast<int*>(rec)[tid] = h[tid];
  }
  const int nayb = K::PP * (round16(win_y) + 8) / 2;     // 32-bit words
  const uint32_t* s_ayb = reinterpret_cast<const uint32_t*>(smem_raw + L.ayc);
  for (int e = tid; e < nayb; e += 128)
    reinterpret_cast<uint32_t*>(rec + RL.ayb)[e] = s_ayb[e];
  const float* s_axt = reinterpret_cast<const float*>(smem_raw + L.axt);
  for (int e = tid; e < sp.X * K::PP; e += 128)
    reinterpret_cast<float*>(rec + RL.axt)[e] = s_axt[sp.cx0 * K::PP + e];
}

// bf16, the pool.  A block of WARPS warps takes one ROI and 16 WARPS
// channels: it copies the ROI's record into shared memory, then each warp
// runs alone: it owns 16 channels (one m-tile) and every p_y tile,
// streams its own channels of the support through its own ring (no block
// barrier in the loop: a stage's cp.async completion and a __syncwarp),
// contracts y with mma.sync and x with FMAs, and writes its output.  A
// stage row is the 32 bytes of 16 channels at (x, r), its two 16-byte
// chunks swapped on rows 4-7 of every 8, so the 8 rows of an ldmatrix hit
// 8 bank groups.
template <int P, int PART>
__global__ void __launch_bounds__(32 * WARPS)
    roi_pool_bf16(const __nv_bfloat16* __restrict__ flat,
                  const unsigned char* __restrict__ recs,
                  float* __restrict__ out, int Hs, int Ws, int C, int win_y,
                  int win_x, int ring_rows) {
  using T = __nv_bfloat16;
  using K = Cfg<P>;
  constexpr int NTP = K::NTP, PP = K::PP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Bf16Smem L = bf16_smem<P>(win_y, win_x, ring_rows);
  const Rec RL = rec_layout<P>(win_y, win_x);
  const int roi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* rec = smem_raw + L.rec;
  {
    const unsigned char* g = recs + (size_t)roi * RL.bytes;
    for (int e = threadIdx.x; e < RL.bytes / 16; e += 32 * WARPS)
      cp_async16(rec + 16 * e, g + 16 * e, 16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int* hdr = reinterpret_cast<const int*>(rec);
  const int R = hdr[1], X = hdr[3], R16 = hdr[4], gr0 = hdr[5], gc0 = hdr[6];
  const int cw0 = blockIdx.y * 16 * WARPS + 16 * warp;   // the warp's channels
  if (cw0 >= C) return;
  const float* s_axt = reinterpret_cast<const float*>(rec + RL.axt);
  const int AYP = round16(win_y) + 8;
  T* ring = reinterpret_cast<T*>(smem_raw + warp * L.warp);
  const int g = lane >> 2, t = lane & 3;

  // acc[p_x][nt * 4 + i]: channel cw0 + g + 8 (i >> 1),
  // p_y nt 8 + 2t + (i & 1)
  float acc[P][4 * NTP];
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int i = 0; i < 4 * NTP; ++i) acc[q][i] = 0.0f;

  if (R > 0 && X > 0 && PART != 1) {
    const int XC = L.cap / R16;                  // window columns a stage
    const int chunks = (X + XC - 1) / XC;
    const int stage = L.cap * 16;                // elements
    // stage k: columns [k XC, k XC + XC) of the support, rows [0, R16);
    // lane: row (lane >> 1) of every 16, chunk lane & 1
    const int lr = lane >> 1, lch = lane & 1;
    const int c = cw0 + 8 * lch;
    auto load = [&](int k) {
      if (k < chunks) {
        T* dst = ring + (k % NSTAGE) * stage;
        for (int xi = 0; xi < XC; ++xi) {
          const int x = k * XC + xi, gc = gc0 + x;
          const bool col_ok = x < X && gc >= 0 && gc < Ws && c < C;
          for (int r = lr; r < R16; r += 16) {
            const int gr = gr0 + r;
            const bool ok = col_ok && r < R && gr >= 0 && gr < Hs;
            const T* src = ok ? flat + ((size_t)gr * Ws + gc) * C + c : flat;
            cp_async16(dst + ((xi * R16 + r) * 2 + (lch ^ ((r >> 2) & 1))) * 8,
                       src, ok ? 16 : 0);
          }
        }
      }
      cp_async_commit();
    };
    const __nv_bfloat16* ayb =
        reinterpret_cast<const __nv_bfloat16*>(rec + RL.ayb) + g * AYP +
        2 * t;
    const int q = lane >> 3;
    const int arow = (lane & 7) + 8 * (q >> 1), achunk = q & 1;
    for (int k = 0; k < NSTAGE - 1; ++k) load(k);
    for (int k = 0; k < chunks; ++k) {
      cp_async_wait<NSTAGE - 2>();
      __syncwarp();           // stage k is in; stage k - 1 is read
      load(k + NSTAGE - 1);
      if constexpr (PART == 2) continue;
      const T* st = ring + (k % NSTAGE) * stage;
      const int nx = min(XC, X - k * XC);
      // two columns at a time where there are two: their mma chains are
      // independent, so each hides the other's latency
      auto columns = [&](auto nc_tag, int xi) {
        constexpr int NC = decltype(nc_tag)::value;
        float d[NC][NTP][4];
#pragma unroll
        for (int u = 0; u < NC; ++u)
#pragma unroll
          for (int nt = 0; nt < NTP; ++nt)
            d[u][nt][0] = d[u][nt][1] = d[u][nt][2] = d[u][nt][3] = 0.0f;
        for (int k0 = 0; k0 < R16; k0 += 16) {
          const int r = k0 + arow;
          const int off = (r * 2 + (achunk ^ ((r >> 2) & 1))) * 8;
          uint32_t a[NC][4];
#pragma unroll
          for (int u = 0; u < NC; ++u)
            ldmatrix_x4_trans(a[u], st + (xi + u) * R16 * 16 + off);
#pragma unroll
          for (int nt = 0; nt < NTP; ++nt) {
            const T* b = ayb + nt * 8 * AYP + k0;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 8);
#pragma unroll
            for (int u = 0; u < NC; ++u) mma_bf16(d[u][nt], a[u], b0, b1);
          }
        }
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float* axx = s_axt + (k * XC + xi + u) * PP;
#pragma unroll
          for (int p4 = 0; p4 < PP / 4; ++p4) {
            const float4 w4 = *reinterpret_cast<const float4*>(axx + 4 * p4);
            const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * p4 + j < P) {
#pragma unroll
                for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
                  for (int i = 0; i < 4; ++i)
                    acc[4 * p4 + j][nt * 4 + i] = fmaf(
                        w[j], d[u][nt][i], acc[4 * p4 + j][nt * 4 + i]);
              }
            }
          }
        }
      };
      int xi = 0;
      for (; xi + 1 < nx; xi += 2)
        columns(std::integral_constant<int, 2>(), xi);
      if (xi < nx) columns(std::integral_constant<int, 1>(), xi);
    }
    cp_async_wait<0>();
  }

  // the warp's output tile [p_y][p_x][16] over its ring, then 64-byte rows
  __syncwarp();
  float* tile = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int py = nt * 8 + 2 * t + (i & 1), ch = g + 8 * (i >> 1);
      if (py < P)
#pragma unroll
        for (int px = 0; px < P; ++px)
          tile[(py * P + px) * 16 + ch] = acc[px][nt * 4 + i];
    }
  __syncwarp();
  float* o = out + (size_t)roi * P * P * C + cw0;
  for (int e = lane; e < P * P * 4; e += 32) {
    const int row = e >> 2, c4 = 4 * (e & 3);
    if (cw0 + c4 < C)
      *reinterpret_cast<float4*>(o + (size_t)row * C + c4) =
          *reinterpret_cast<const float4*>(tile + row * 16 + c4);
  }
}

// float32 (single-nav's batch-1 first detect), CUDA cores: a block of 32 P
// threads per (ROI, F32_CT channels).  It loads the ROI's hat matrices and
// finds their support, then streams the window's support rows through
// shared memory, double-buffered with cp.async (F32_CT channels x the
// support's columns a row), and contracts each row as it lands: warp q
// (one per output column p_x = q) forms
//     u[c] = sum_x A_x[q, x] * W[r, x, c]
// for its lane's two channels and folds it into the p_y accumulators,
//     acc[p_y][c] += A_y[p_y, r] * u[c],
// float32 FMAs.  x before y is the same sum in another association; it
// needs no (p, win_x, C) intermediate.  (Register tiles of 8 and of 4 p_y
// a thread, y first, measured slower at three of the four detect shapes:
// PERF.md.)
constexpr int F32_CT = 64;

template <int P, int PART>
__global__ void __launch_bounds__(32 * P)
    roi_pool_f32(const float* __restrict__ flat, const float* __restrict__ ay,
                 const float* __restrict__ ax, const int* __restrict__ row0,
                 const int* __restrict__ col0, float* __restrict__ out,
                 int Hs, int Ws, int C, int win_y, int win_x) {
  constexpr int NT = 32 * P;
  constexpr int CPC = F32_CT / 4;           // 16-byte chunks a row's column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range[4];

  const int roi = blockIdx.x;
  const int c0 = blockIdx.y * F32_CT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int px = tid >> 5;

  float* rows = reinterpret_cast<float*>(smem_raw);     // 2 x win_x x CT
  float* s_ay = rows + 2 * (size_t)win_x * F32_CT;
  float* s_ax = s_ay + P * win_y;                       // P x win_x

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
      const float v = g_ay[q * win_y + r];
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
      const float v = g_ax[q * win_x + w];
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

  if (ry1 > ry0 && cx1 > cx0 && PART != 1) {
    const int ncol = cx1 - cx0;
    const int gr0 = row0[roi], gc0 = col0[roi] + cx0;
    // one support row of the window into buffer `buf`; cells outside the
    // buffer (and channels past C) are zero-filled
    auto load_row = [&](int r, int buf) {
      float* dst = rows + (size_t)buf * win_x * F32_CT;
      const int gr = gr0 + r;
      const bool row_ok = gr >= 0 && gr < Hs;
      for (int e = tid; e < ncol * CPC; e += NT) {
        const int w = e / CPC, k = e - w * CPC;
        const int gc = gc0 + w, ch = c0 + 4 * k;
        const bool ok = row_ok && gc >= 0 && gc < Ws && ch < C;
        const float* src = ok ? flat + ((size_t)gr * Ws + gc) * C + ch
                              : flat;
        cp_async16(dst + (size_t)w * F32_CT + 4 * k, src, ok ? 16 : 0);
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
      if constexpr (PART != 2) {
        const float* row = rows + (size_t)buf * win_x * F32_CT + 2 * lane;
        const float* axq = s_ax + px * win_x + cx0;
        float u0 = 0.0f, u1 = 0.0f;
        for (int w = 0; w < ncol; ++w) {
          const float2 v =
              *reinterpret_cast<const float2*>(row + (size_t)w * F32_CT);
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

template <int P>
size_t f32_smem(int win_y, int win_x) {
  return 2 * (size_t)win_x * F32_CT * 4 + 4 * (size_t)P * (win_y + win_x);
}

template <int P, int PART>
int launch_f32(const void* flat, const float* ay, const float* ax,
               const int* row0, const int* col0, float* out, int n, int Hs,
               int Ws, int C, int win_y, int win_x, cudaStream_t stream) {
  auto kern = roi_pool_f32<P, PART>;
  const size_t smem = f32_smem<P>(win_y, win_x);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n, (C + F32_CT - 1) / F32_CT);
  kern<<<grid, 32 * P, smem, stream>>>(static_cast<const float*>(flat), ay,
                                       ax, row0, col0, out, Hs, Ws, C, win_y,
                                       win_x);
  return (int)cudaGetLastError();
}

template <int P, int PART>
int launch_bf16(const void* flat, const float* ay, const float* ax,
                const int* row0, const int* col0, void* recs, float* out,
                int n, int Hs, int Ws, int C, int win_y, int win_x,
                int ring_rows, cudaStream_t stream) {
  auto prep = roi_prep<P>;
  const size_t smem0 = prep_layout<P>(win_y, win_x).total;
  cudaError_t err = cudaFuncSetAttribute(
      prep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem0);
  if (err != cudaSuccess) return (int)err;
  prep<<<n, 128, smem0, stream>>>(ay, ax, row0, col0,
                                  static_cast<unsigned char*>(recs), win_y,
                                  win_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kern = roi_pool_bf16<P, PART>;
  const size_t smem = bf16_smem<P>(win_y, win_x, ring_rows).total;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n, (C + 16 * WARPS - 1) / (16 * WARPS));
  kern<<<grid, 32 * WARPS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(flat),
      static_cast<const unsigned char*>(recs), out, Hs, Ws, C, win_y, win_x,
      ring_rows);
  return (int)cudaGetLastError();
}

template <int PART>
int launch(const void* flat, int is_bf16, const float* ay, const float* ax,
           const int* row0, const int* col0, void* recs, float* out, int n,
           int p, int Hs, int Ws, int C, int win_y, int win_x, int ring_rows,
           cudaStream_t s) {
  if (is_bf16) {
    if (p == 7)
      return launch_bf16<7, PART>(flat, ay, ax, row0, col0, recs, out, n, Hs,
                                  Ws, C, win_y, win_x, ring_rows, s);
    if (p == 14)
      return launch_bf16<14, PART>(flat, ay, ax, row0, col0, recs, out, n,
                                   Hs, Ws, C, win_y, win_x, ring_rows, s);
  } else {
    if (p == 7)
      return launch_f32<7, PART>(flat, ay, ax, row0, col0, out, n, Hs, Ws, C,
                                 win_y, win_x, s);
    if (p == 14)
      return launch_f32<14, PART>(flat, ay, ax, row0, col0, out, n, Hs, Ws,
                                  C, win_y, win_x, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" size_t roi_window_smem_bytes(int is_bf16, int p, int win_y,
                                        int win_x, int ring_rows) {
  if (is_bf16)
    return p == 7 ? bf16_smem<7>(win_y, win_x, ring_rows).total
                  : bf16_smem<14>(win_y, win_x, ring_rows).total;
  return p == 7 ? f32_smem<7>(win_y, win_x) : f32_smem<14>(win_y, win_x);
}

// Bytes of the bf16 path's per-ROI record (scratch: n of them).
extern "C" size_t roi_window_rec_bytes(int p, int win_y, int win_x) {
  return p == 7 ? rec_layout<7>(win_y, win_x).bytes
                : rec_layout<14>(win_y, win_x).bytes;
}

// The pooled sizes the kernel is built for, Mask R-CNN's box and mask heads
// (p is a template parameter: the accumulators live in registers).
extern "C" int roi_window_supports_p(int p) { return p == 7 || p == 14; }

// flat: (Hs, Ws, C) float32 (is_bf16 = 0) or bfloat16 (1), contiguous, 16-
// byte aligned, C a multiple of 8; ay (n, p, win_y), ax (n, p, win_x)
// float32; row0, col0 (n,) int32 window origins (any value: out-of-buffer
// cells read as zero); recs: scratch of n x roi_window_rec_bytes (bf16);
// out (n, p, p, C) float32.  Launches on `stream`; returns the
// cudaError_t.
extern "C" int roi_window_pool_launch(const void* flat, int is_bf16,
                                      const float* ay, const float* ax,
                                      const int* row0, const int* col0,
                                      void* recs, float* out, int n, int p,
                                      int Hs, int Ws, int C, int win_y,
                                      int win_x, void* stream) {
  return launch<0>(flat, is_bf16, ay, ax, row0, col0, recs, out, n, p, Hs,
                   Ws, C, win_y, win_x, RING_ROWS, (cudaStream_t)stream);
}

// The rows of a bf16 ring stage the pool launches with.
extern "C" int roi_window_ring_rows() { return RING_ROWS; }

// The same launch for chip_smoke.py's breakdown, uncounted: part 0 the
// whole pool, 1 the output write alone, 2 also the window loads; bf16 with
// ring stages of ring_rows rows (float32 streams whole support rows).
extern "C" int roi_window_pool_part_launch(
    const void* flat, int is_bf16, const float* ay, const float* ax,
    const int* row0, const int* col0, void* recs, float* out, int n, int p,
    int Hs, int Ws, int C, int win_y, int win_x, int ring_rows, int part,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (part == 0)
    return launch<0>(flat, is_bf16, ay, ax, row0, col0, recs, out, n, p, Hs,
                     Ws, C, win_y, win_x, ring_rows, s);
  if (part == 1)
    return launch<1>(flat, is_bf16, ay, ax, row0, col0, recs, out, n, p, Hs,
                     Ws, C, win_y, win_x, ring_rows, s);
  if (part == 2)
    return launch<2>(flat, is_bf16, ay, ax, row0, col0, recs, out, n, p, Hs,
                     Ws, C, win_y, win_x, ring_rows, s);
  return (int)cudaErrorInvalidValue;
}
