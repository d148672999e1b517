// One directed second-order block sweep, one thread-block cluster per grid
// (sm_90a).
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
// Design.  A cluster of C CUDA blocks per grid (C and the segment width
// `seg` come from the launch plan, fmm_sweep.py::sweep_plan); block q owns
// the columns [q * seg, q * seg + width).  Each block keeps its segment of
// the current row block, the four context rows and its walls and sources in
// shared memory, double-buffered (Jacobi), and relaxes it a thread per
// cell.  The two columns beyond each edge of the segment are read from the
// neighbours' current buffer through DSMEM.  The carry and the far context
// are the segment's own columns, so nothing else crosses blocks.  One
// cluster barrier ends every pass: with two buffers it both publishes the
// pass to the neighbours and tells them its input buffer is free to be
// written.  Input and output are separate global buffers, so the far
// context always reads the stale input.  Same operation order and
// arithmetic as the plain version (fmm.py::_order2_block): the three
// multiply-adds of _godunov2 round once (fma1), the other products are
// __fmul_rn so nvcc cannot contract them, and sqrtf is correctly rounded.
// So the result equals the plain PyTorch version's on the card bit for bit.
//
// Bound.  As chip_smoke.py counts it: bytes read d (4 B) + wall + src
// (1 B each), write d (4 B): 16 x 482^2 x 10 B = 37 MB -> 11 us at
// 3.35 TB/s; work inner passes of 70 operations per cell: 16 x 482^2 x 40 x
// 70 = 1.04e10 -> 0.155 ms at 67 TFLOP/s fp32.  What holds it is the chain:
// ceil(H/block) dependent row blocks x inner dependent passes, each a
// stencil over seg x block cells and one cluster barrier (31 x 40 = 1240
// links at 482, 2400 at 960).  The cluster cuts a link's stencil work by C
// (one SM per grid before) and adds the barrier and the halo's DSMEM reads.

#include "fmm_common.cuh"

namespace {

constexpr int NT = SWEEP_NT;

__global__ void __launch_bounds__(NT, 1)
block_sweep2_kernel(const float* __restrict__ d_in,
                    const uint8_t* __restrict__ wall,
                    const uint8_t* __restrict__ src,
                    float* __restrict__ d_out, int H, int W, int block,
                    int inner, int reverse, int seg) {
  extern __shared__ float smem[];
  const Cluster cl = cluster_init(W, seg);
  const int w = cl.width, c0 = cl.c0;
  const size_t plane = (size_t)H * W;
  const float* Din = d_in + cl.grid * plane + c0;
  const uint8_t* wl_g = wall + cl.grid * plane + c0;
  const uint8_t* sr_g = src + cl.grid * plane + c0;
  float* Dout = d_out + cl.grid * plane + c0;

  // ctx buffers, rows of seg cells: rows 0-1 top context, 2..2+R-1 the
  // block, then 2 bottom context rows
  const int ctx_rows = block + 4;
  float* ctx0 = smem;
  float* ctx1 = ctx0 + (size_t)ctx_rows * seg;
  uint8_t* wl = reinterpret_cast<uint8_t*>(ctx1 + (size_t)ctx_rows * seg);
  uint8_t* sr = wl + (size_t)block * seg;
  // the neighbours' buffers (only read where a neighbour exists)
  const int left = imax(cl.rank - 1, 0), right = imin(cl.rank + 1,
                                                      cl.size - 1);
  const float *left0 = peer(ctx0, left), *left1 = peer(ctx1, left);
  const float *right0 = peer(ctx0, right), *right1 = peer(ctx1, right);

  const int nb = (H + block - 1) / block;
  for (int j = 0; j < nb; ++j) {
    const int k = reverse ? nb - 1 - j : j;
    const int r0 = k * block;
    const int R = imin(block, H - r0);
    const int n = R * w;
    // near context: the carry (top going down, bottom going up), written
    // by the previous block, BIG before the first; far context: the input
    // field's two rows beyond the block
    float* near_rows = ctx0 + (reverse ? (size_t)(2 + R) * seg : 0);
    float* far_rows = ctx0 + (reverse ? 0 : (size_t)(2 + R) * seg);
    if (j == 0)
      for (int e = threadIdx.x; e < 2 * seg; e += NT) near_rows[e] = BIG;
    for (int e = threadIdx.x; e < n; e += NT) {
      const int r = e / w, c = e - r * w;
      const size_t g = (size_t)(r0 + r) * W + c;
      ctx0[(size_t)(2 + r) * seg + c] = Din[g];
      wl[r * seg + c] = wl_g[g];
      sr[r * seg + c] = sr_g[g];
    }
    for (int e = threadIdx.x; e < 2 * w; e += NT) {
      const int i = e / w, c = e - i * w;
      const int row = reverse ? r0 - 2 + i : r0 + block + i;
      far_rows[i * seg + c] =
          (row >= 0 && row < H) ? Din[(size_t)row * W + c] : BIG;
    }
    __syncthreads();
    // context rows are the same in both buffers
    for (int e = threadIdx.x; e < 2 * seg; e += NT) {
      ctx1[e] = ctx0[e];
      ctx1[(size_t)(2 + R) * seg + e] = ctx0[(size_t)(2 + R) * seg + e];
    }
    cluster_barrier(cl.size);   // every segment of the block is loaded

    int p = 0;           // the buffer that holds the current pass
    for (int it = 0; it < inner; ++it) {
      const float* cur = p ? ctx1 : ctx0;
      float* nxt = p ? ctx0 : ctx1;
      const float* lcur = p ? left1 : left0;
      const float* rcur = p ? right1 : right0;
      for (int e = threadIdx.x; e < n; e += NT) {
        const int r = e / w, c = e - r * w;
        const int gc = c0 + c;
        const size_t o = (size_t)(r + 2) * seg;     // the cell's row
        const float* row = cur + o;
        const float up2 = cur[o - 2 * seg + c], up1 = cur[o - seg + c];
        const float mid = row[c];
        const float dn1 = cur[o + seg + c], dn2 = cur[o + 2 * seg + c];
        // 1- and 2-away cells in the row, from the neighbours' segments
        // past this one's edges, BIG past the grid's
        const float lf1 = gc < 1 ? BIG : c >= 1 ? row[c - 1]
                                                : lcur[o + seg - 1];
        const float lf2 = gc < 2 ? BIG : c >= 2 ? row[c - 2]
                                                : lcur[o + seg - 2 + c];
        const float rt1 = gc + 1 >= W ? BIG : c + 1 < w ? row[c + 1]
                                                        : rcur[o + c + 1 - w];
        const float rt2 = gc + 2 >= W ? BIG : c + 2 < w ? row[c + 2]
                                                        : rcur[o + c + 2 - w];
        float u1y, u2y, u1x, u2x;
        pick_dir(up1, up2, dn1, dn2, &u1y, &u2y);
        pick_dir(lf1, lf2, rt1, rt2, &u1x, &u2x);
        const float cand = godunov2(u1x, u2x, u1y, u2y);
        const int m = r * seg + c;
        const float out = sr[m] ? 0.0f : fminf(mid, cand);
        nxt[o + c] = wl[m] ? BIG : out;
      }
      // publishes this pass and frees the buffer it read for the next
      cluster_barrier(cl.size);
      p ^= 1;
    }

    float* res = (p ? ctx1 : ctx0) + 2 * (size_t)seg;
    float* free_buf = p ? ctx0 : ctx1;
    for (int e = threadIdx.x; e < n; e += NT) {
      const int r = e / w, c = e - r * w;
      Dout[(size_t)(r0 + r) * W + c] = res[r * seg + c];
    }
    if (j + 1 == nb) break;
    // carry for the next block: this block's two edge rows on the side the
    // sweep moves to (padded rows past H are BIG), staged in the free
    // buffer's first rows, then placed as the next block's near context
    for (int e = threadIdx.x; e < 2 * seg; e += NT) {
      const int i = e / seg, c = e - i * seg;
      const int br = reverse ? i : R - 2 + i;      // row within this block
      free_buf[e] = (br >= 0 && br < R) ? res[(size_t)br * seg + c] : BIG;
    }
    __syncthreads();
    const int next_R = imin(block, H - (reverse ? k - 1 : k + 1) * block);
    float* next_near = ctx0 + (reverse ? (size_t)(2 + next_R) * seg : 0);
    for (int e = threadIdx.x; e < 2 * seg; e += NT) next_near[e] = free_buf[e];
    __syncthreads();
  }
  // no block leaves while a neighbour may still read its shared memory
  cluster_barrier(cl.size);
}

}  // namespace

extern "C" size_t block_sweep2_smem_bytes(int seg, int block) {
  return 2 * (size_t)(block + 4) * seg * sizeof(float) +
         2 * (size_t)block * seg;
}

// Resident clusters of `cluster` blocks at this segment width and block
// height, into *out; returns the cudaError_t of the query.
extern "C" int block_sweep2_max_clusters(int seg, int block, int cluster,
                                         int* out) {
  return max_active_clusters(block_sweep2_kernel, cluster,
                             block_sweep2_smem_bytes(seg, block), out);
}

// (B, H, W) float32 field, uint8 wall/source masks -> (B, H, W) float32
// into d_out (which must not alias d_in), B clusters of `cluster` blocks of
// `seg` columns each (the launch plan's).  Launches on `stream`; returns
// the cudaError_t of the launch.
extern "C" int block_sweep2_launch(const float* d_in, const uint8_t* wall,
                                   const uint8_t* src, float* d_out, int B,
                                   int H, int W, int block, int inner,
                                   int reverse, int cluster, int seg,
                                   void* stream) {
  const size_t smem = block_sweep2_smem_bytes(seg, block);
  cudaError_t err = cluster_attributes(block_sweep2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(B, cluster, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, block_sweep2_kernel, d_in, wall, src, d_out,
                           H, W, block, inner, reverse, seg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

namespace {

__global__ void __launch_bounds__(NT, 1) cluster_barrier_kernel(int n) {
  for (int i = 0; i < n; ++i) cooperative_groups::this_cluster().sync();
}

}  // namespace

// `n` cluster barriers and nothing else, in B clusters of `cluster`
// blocks of the sweeps' size: what chip_smoke.py prices a barrier with.
extern "C" int cluster_barrier_loop(int B, int cluster, int n, void* stream) {
  cudaError_t err = cluster_attributes(cluster_barrier_kernel, 0);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(B, cluster, 0, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
