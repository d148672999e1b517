// Whole first-order eikonal solve, one CUDA block per grid (sm_90a).
//
// Replaces the TPU kernel peanut_tpu/kernels/fmm_fused.py::fused_eikonal
// (body _fused_kernel, helpers _relax_block, _seg_scan_lr, vscan_chunks).
// Computes what it computes: `rounds` times { optional column min-plus
// scans; a down pass and an up pass over `block`-row blocks }, each block
// relaxed by inner/scan_chunk rounds of { segmented row min-plus scans in
// both directions; scan_chunk Jacobi Godunov passes } against its boundary
// rows.  Down pass: top = the previous block's relaxed last row (carried),
// bottom = the next block's first row as it stands in the grid.  Up pass:
// bottom = the next block's relaxed first row (carried), top = the previous
// block's last row as it stands.  Walls are BIG; a source on a wall is a
// source.  The last block may be ragged (482 = 30 x 16 + 2): rows past H
// do not exist and the boundary beyond them is BIG, which is what the TPU
// kernel's wall padding amounts to.
//
// Design.  One block of NT threads per grid (batch item); the grid lives in
// global memory (the output buffer, L2-resident at 16 x 482^2 x 4 B), the
// current row block in shared memory, double-buffered so every stencil pass
// reads only the previous pass (Jacobi, as the TPU kernel does: an
// in-place update would be Gauss-Seidel and a different schedule).  The
// row scans are the same Hillis-Steele scans as the plain version
// (fmm.py::_RowScan), a warp per row held in registers (shuffles for the
// short shifts), so they need no block-wide barrier and no shared memory
// traffic; the column scans run the same scan block-wide through shared
// memory over 16-column chunks of the whole grid.  The stencil runs a
// thread per column down the block.  The kernel keeps the plain version's
// operation order and its arithmetic: the one multiply-add of the update
// rounds once (fma1: the FMA XLA contracts on the CPU, which the plain
// version takes through float64, fmm.py::_fma), sqrtf is correctly
// rounded, and nothing else can contract.  So its result equals the plain
// PyTorch version's on the card bit for bit.
//
// Bound (as chip_smoke.py counts it).  Bytes: read trav+src (2 B/cell),
// write the field (4 B/cell): 16 x 482^2 x 6 B = 22 MB -> 6.7 us at
// 3.35 TB/s.  Work: every row is relaxed 2 x rounds times, each time with
// inner stencil passes (17 operations/cell) and 2 x inner/chunk sequential
// min-plus scans (3 operations/cell): 16 x 482^2 x 2 x 2 x (17 x 40 +
// 6 x 10) = 1.1e10 operations -> 0.16 ms at 67 TFLOP/s fp32.  The real
// limit is latency: ceil(482/16) = 31 dependent blocks x 2 passes x rounds,
// each with inner dependent passes behind a block-wide barrier, on 16 of
// 132 SMs.

#include "fmm_common.cuh"

namespace {

constexpr int NT = 512;          // threads per block
constexpr int K_MAX = 32;        // cells per thread in a column-scan step
constexpr int VSCAN_COLS = 16;   // columns per column-scan chunk

// Hillis-Steele segmented min-plus scan over `n` cells laid out as lines of
// `len` cells with stride `step` between consecutive cells of a line
// (step 1: rows; step = chunk width: columns).  sa/sb hold (a, b) on entry
// (walls (BIG, BIG), others (1, d)); on exit sb holds the scanned b.
__device__ void hs_scan(float* sa, float* sb, int n, int len, int step,
                        bool reverse) {
  for (int s = 1; s < len; s <<= 1) {
    float na[K_MAX], nb[K_MAX];
#pragma unroll
    for (int j = 0; j < K_MAX; ++j) {
      int e = threadIdx.x + j * NT;
      if (e < n) {
        int pos = (step == 1) ? (e % len) : (e / step);
        bool has = reverse ? (pos + s < len) : (pos >= s);
        int o = reverse ? e + s * step : e - s * step;
        float a_n = has ? sa[o] : 0.0f;
        float b_n = has ? sb[o] : BIG;
        float a = sa[e];
        nb[j] = fminf(sb[e], b_n + a);
        na[j] = fminf(a_n + a, BIG);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K_MAX; ++j) {
      int e = threadIdx.x + j * NT;
      if (e < n) {
        sa[e] = na[j];
        sb[e] = nb[j];
      }
    }
    __syncthreads();
  }
}

template <int KW>
__global__ void __launch_bounds__(NT, 1)
fused_eikonal_kernel(const uint8_t* __restrict__ trav,
                     const uint8_t* __restrict__ src, float* __restrict__ out,
                     int H, int W, int rounds, int block, int inner,
                     int scan_chunk, int vscan) {
  extern __shared__ float smem[];
  const size_t plane = (size_t)H * W;
  const uint8_t* tv = trav + blockIdx.x * plane;
  const uint8_t* sr = src + blockIdx.x * plane;
  float* D = out + blockIdx.x * plane;

  const int S = imax(block * W, H * VSCAN_COLS);
  float* cur = smem;
  float* nxt = cur + S;
  float* sa = nxt + S;
  float* rowA = sa + S;
  float* rowB = rowA + W;
  uint8_t* wl = reinterpret_cast<uint8_t*>(rowB + W);

  for (size_t e = threadIdx.x; e < plane; e += NT)
    D[e] = sr[e] ? 0.0f : BIG;
  __syncthreads();

  const int nb = (H + block - 1) / block;
  for (int rd = 0; rd < rounds; ++rd) {
    if (vscan) {
      // column scans, both directions, chunk by chunk (fused
      // vscan_chunks): e = r * cw + cc within a chunk of cw columns
      for (int c0 = 0; c0 < W; c0 += VSCAN_COLS) {
        int cw = imin(VSCAN_COLS, W - c0);
        int n = H * cw;
        for (int dir = 0; dir < 2; ++dir) {
          for (int e = threadIdx.x; e < n; e += NT) {
            size_t g = (size_t)(e / cw) * W + c0 + e % cw;
            bool w = !tv[g] && !sr[g];
            sa[e] = w ? BIG : 1.0f;
            nxt[e] = w ? BIG : D[g];
          }
          __syncthreads();
          hs_scan(sa, nxt, n, H, cw, dir == 1);
          for (int e = threadIdx.x; e < n; e += NT) {
            size_t g = (size_t)(e / cw) * W + c0 + e % cw;
            D[g] = fminf(D[g], nxt[e]);
          }
          __syncthreads();
        }
      }
    }
    for (int pass = 0; pass < 2; ++pass) {
      const bool up_pass = pass == 1;
      // carried boundary row: rowA (top) going down, rowB (bottom) going up
      float* carry = up_pass ? rowB : rowA;
      for (int c = threadIdx.x; c < W; c += NT) carry[c] = BIG;
      for (int j = 0; j < nb; ++j) {
        int k = up_pass ? nb - 1 - j : j;
        int r0 = k * block;
        int R = imin(block, H - r0);
        int n = R * W;
        const float* blk_in = D + (size_t)r0 * W;
        for (int e = threadIdx.x; e < n; e += NT) {
          size_t g = (size_t)r0 * W + e;
          cur[e] = blk_in[e];
          wl[e] = !tv[g] && !sr[g];
        }
        // the uncarried boundary row, as it stands in the grid
        for (int c = threadIdx.x; c < W; c += NT) {
          if (!up_pass)
            rowB[c] = r0 + R < H ? D[(size_t)(r0 + R) * W + c] : BIG;
          else
            rowA[c] = k > 0 ? D[(size_t)(r0 - 1) * W + c] : BIG;
        }
        __syncthreads();
        float* res = relax_block<NT, KW>(cur, nxt, wl, rowA, rowB, R, W,
                                         inner, scan_chunk);
        float* blk_out = D + (size_t)r0 * W;
        for (int e = threadIdx.x; e < n; e += NT) blk_out[e] = res[e];
        const float* edge = up_pass ? res : res + (size_t)(R - 1) * W;
        __syncthreads();   // relax_block's readers of carry are done
        for (int c = threadIdx.x; c < W; c += NT) carry[c] = edge[c];
        __syncthreads();
      }
    }
  }
  for (size_t e = threadIdx.x; e < plane; e += NT)
    if (D[e] >= HALF_BIG) D[e] = __int_as_float(0x7f800000);   // +inf
}

}  // namespace

extern "C" size_t fused_eikonal_smem_bytes(int H, int W, int block) {
  size_t S = (size_t)imax(block * W, H * VSCAN_COLS);
  return 3 * S * sizeof(float) + 2 * (size_t)W * sizeof(float) +
         (size_t)block * W;
}

// (B, H, W) uint8 traversible/source masks -> (B, H, W) float32 distances,
// +inf at walls and unreachable cells.  Launches on `stream`; returns the
// cudaError_t of the launch.
template <int KW>
static int launch(const uint8_t* trav, const uint8_t* src, float* out, int B,
                  int H, int W, int rounds, int block, int inner,
                  int scan_chunk, int vscan, cudaStream_t stream) {
  size_t smem = fused_eikonal_smem_bytes(H, W, block);
  cudaError_t err = cudaFuncSetAttribute(
      fused_eikonal_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_eikonal_kernel<KW><<<B, NT, smem, stream>>>(
      trav, src, out, H, W, rounds, block, inner, scan_chunk, vscan);
  return (int)cudaGetLastError();
}

extern "C" int fused_eikonal_launch(const uint8_t* trav, const uint8_t* src,
                                    float* out, int B, int H, int W,
                                    int rounds, int block, int inner,
                                    int scan_chunk, int vscan,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (W <= 32 * 16)
    return launch<16>(trav, src, out, B, H, W, rounds, block, inner,
                      scan_chunk, vscan, st);
  if (W <= 32 * 32)
    return launch<32>(trav, src, out, B, H, W, rounds, block, inner,
                      scan_chunk, vscan, st);
  return (int)cudaErrorInvalidValue;     // rows wider than 1024 cells
}

extern "C" int fused_eikonal_max_cells() { return NT * K_MAX; }
