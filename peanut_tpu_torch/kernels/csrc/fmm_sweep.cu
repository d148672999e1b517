// One directed first-order block sweep, one CUDA block per grid (sm_90a).
//
// Replaces the TPU kernel peanut_tpu/kernels/fmm_pallas.py::
// pallas_block_sweep (body _sweep_kernel_batched, helpers _seg_scan_lr,
// _godunov) together with its wrapper v_sweep_pallas, which pads the rows
// and flips them for the reverse direction.  Per row block, in sweep
// order: inner/scan_chunk rounds of { both segmented row min-plus scans;
// scan_chunk Jacobi Godunov stencil passes } against two boundary rows: on
// the near side the previous block's relaxed edge row (carried; BIG before
// the first block), on the far side the next block's edge row of the INPUT
// field (stale: before this sweep; BIG past the grid).  Blocks tile the
// rows from row 0; the last may be ragged, and rows past H do not exist,
// which is what the TPU wrapper's wall padding amounts to.  `reverse`
// sweeps the same blocks bottom-up with mirrored boundaries, which equals
// the wrapper's flip after padding (the stencil and the row scans are
// mirror-invariant in the row direction).  The carry starts anew for every
// grid of the batch.
//
// Design.  One block of NT threads per grid; the input and output fields in
// global memory, the current row block and its walls in shared memory,
// double-buffered so every stencil pass reads only the previous pass
// (Jacobi), and the two boundary rows beside them.  Input and output are
// separate buffers, so the far row always reads the stale input.  The
// relaxation is B1's (fmm_common.cuh::relax_block): a warp per row for the
// two scans in registers, a thread per column for the stencil, the plain
// version's association and rounding, so the result equals the plain
// PyTorch version (fmm.py::_v_sweep) bit for bit.  Rows up to 512 cells run
// 512 threads with 16 cells a lane; rows up to 1024 cells (the 960^2
// goal-weighting solve) run 256 threads with 32 cells a lane, so a thread
// may hold the 4 x 32 registers of a shuffle step.
//
// Bound (as chip_smoke.py counts it).  Bytes: read d (4 B) + wall (1 B),
// write d (4 B): 482^2 x 9 B = 2.1 MB -> 0.62 us at 3.35 TB/s.  Work: inner
// stencil passes (17 operations/cell) and 2 x inner/scan_chunk sequential
// min-plus scans (3 operations/cell): 482^2 x (17 x 40 + 6 x 40) = 2.1e8
// -> 3.2 us at 67 TFLOP/s fp32.  The real limit is latency: ceil(482/16) =
// 31 dependent blocks x inner dependent passes behind block-wide barriers,
// on one of 132 SMs for the single-env agent's one grid.

#include "fmm_common.cuh"

namespace {

template <int NT, int KW>
__global__ void __launch_bounds__(NT, 1)
block_sweep_kernel(const float* __restrict__ d_in,
                   const uint8_t* __restrict__ wall,
                   float* __restrict__ d_out, int H, int W, int block,
                   int inner, int scan_chunk, int reverse) {
  extern __shared__ float smem[];
  const size_t plane = (size_t)H * W;
  const float* Din = d_in + blockIdx.x * plane;
  const uint8_t* wl_g = wall + blockIdx.x * plane;
  float* Dout = d_out + blockIdx.x * plane;

  const size_t S = (size_t)block * W;
  float* cur = smem;
  float* nxt = cur + S;
  float* rowA = nxt + S;               // top boundary row
  float* rowB = rowA + W;              // bottom boundary row
  uint8_t* wl = reinterpret_cast<uint8_t*>(rowB + W);

  // carried boundary row: rowA (top) going down, rowB (bottom) going up
  float* carry = reverse ? rowB : rowA;
  for (int c = threadIdx.x; c < W; c += NT) carry[c] = BIG;

  const int nb = (H + block - 1) / block;
  for (int j = 0; j < nb; ++j) {
    const int k = reverse ? nb - 1 - j : j;
    const int r0 = k * block;
    const int R = imin(block, H - r0);
    const int n = R * W;
    for (int e = threadIdx.x; e < n; e += NT) {
      const size_t g = (size_t)r0 * W + e;
      cur[e] = Din[g];
      wl[e] = wl_g[g];
    }
    // the far boundary row, as it stands in the input field
    for (int c = threadIdx.x; c < W; c += NT) {
      if (!reverse)
        rowB[c] = r0 + R < H ? Din[(size_t)(r0 + R) * W + c] : BIG;
      else
        rowA[c] = k > 0 ? Din[(size_t)(r0 - 1) * W + c] : BIG;
    }
    __syncthreads();
    const float* res = relax_block<NT, KW>(cur, nxt, wl, rowA, rowB, R, W,
                                           inner, scan_chunk);
    for (int e = threadIdx.x; e < n; e += NT)
      Dout[(size_t)r0 * W + e] = res[e];
    const float* edge = reverse ? res : res + (size_t)(R - 1) * W;
    __syncthreads();   // relax_block's readers of carry are done
    for (int c = threadIdx.x; c < W; c += NT) carry[c] = edge[c];
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t block_sweep_smem_bytes(int W, int block) {
  return 2 * (size_t)block * W * sizeof(float) +
         2 * (size_t)W * sizeof(float) + (size_t)block * W;
}

template <int NT, int KW>
static int launch(const float* d_in, const uint8_t* wall, float* d_out,
                  int B, int H, int W, int block, int inner, int scan_chunk,
                  int reverse, cudaStream_t stream) {
  size_t smem = block_sweep_smem_bytes(W, block);
  cudaError_t err = cudaFuncSetAttribute(
      block_sweep_kernel<NT, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_sweep_kernel<NT, KW><<<B, NT, smem, stream>>>(
      d_in, wall, d_out, H, W, block, inner, scan_chunk, reverse);
  return (int)cudaGetLastError();
}

// (B, H, W) float32 field, uint8 wall mask -> (B, H, W) float32 into d_out
// (which must not alias d_in).  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int block_sweep_launch(const float* d_in, const uint8_t* wall,
                                  float* d_out, int B, int H, int W,
                                  int block, int inner, int scan_chunk,
                                  int reverse, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (W <= 32 * 16)
    return launch<512, 16>(d_in, wall, d_out, B, H, W, block, inner,
                           scan_chunk, reverse, st);
  if (W <= 32 * 32)
    return launch<256, 32>(d_in, wall, d_out, B, H, W, block, inner,
                           scan_chunk, reverse, st);
  return (int)cudaErrorInvalidValue;     // rows wider than 1024 cells
}
