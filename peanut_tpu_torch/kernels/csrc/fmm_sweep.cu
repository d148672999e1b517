// One directed first-order block sweep, one thread-block cluster per grid
// (sm_90a).
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
// Design.  A cluster of C CUDA blocks per grid (C and the rows each block
// owns come from the launch plan, fmm_sweep.py::sweep_plan).  The cluster
// splits every row block by rows, not columns: block q owns the whole rows
// [q * rows, q * rows + rows) of it (one row each at block 16 and C = 16),
// double-buffered in shared memory (Jacobi), with their walls and, at the
// ends of the row block, the boundary rows.  So a block runs the row scans
// of its rows alone: the scans must keep the plain version's association
// (the Hillis-Steele steps of fmm.py::_RowScan, shifts 1, 2, 4, ..., each
// step reading the previous step's values), because float min-plus is not
// associative bit for bit and a segment-local scan with a carry fix-up
// would differ.  A stencil pass reads the row above and below its rows from
// the neighbouring blocks through DSMEM.  One round of both scans and a
// stencil pass needs one cluster barrier (between the scans and the pass):
// the next round's scans touch only the block's own rows of the buffer the
// pass wrote, and the round's barrier comes before any stencil reads or
// writes a buffer a neighbour may still read.  Each scan runs in two
// phases (scan_phase1, scan_phase2): shifts below 32 in registers through
// shuffles, a warp over 32 cells of a row; the larger shifts through
// shuffles again after a transpose in shared memory, K2 lanes over the
// 32-cell chunks of one column position (rows over 1024 cells: two chunks
// a lane, scan_phase2_wide); a step's a-value comes from the
// walls' run-lengths, computed once per row block (step_a), so only b moves
// between lanes.  The stencil and the scans keep the plain version's
// arithmetic (fmm_common.cuh: fma1, a correctly rounded sqrtf), so the
// result equals the plain PyTorch version (fmm.py::_v_sweep) bit for bit.
// A cluster of one block (narrow rows) holds whole row blocks and uses
// block barriers.
//
// Bound.  As chip_smoke.py counts it: bytes read d (4 B) + wall (1 B),
// write d (4 B): 482^2 x 9 B = 2.1 MB -> 0.62 us at 3.35 TB/s; work inner
// stencil passes (17 operations/cell) and 2 x inner/scan_chunk sequential
// min-plus scans (3 operations/cell): 482^2 x (17 x 40 + 6 x 40) = 2.1e8
// -> 3.2 us at 67 TFLOP/s fp32.  What holds it is the chain: ceil(H/block)
// dependent row blocks x inner/scan_chunk rounds (31 x 40 = 1240 at 482,
// 60 x 40 = 2400 at 960), each both scans, one cluster barrier (~0.7 us on
// the H100, scripts/torch_sweep_breakdown.py) and a stencil pass.  The
// cluster spreads a round over 16 SMs (one SM per grid, a warp carrying a
// whole row serially, before) and pays one barrier a round for it.

#include "fmm_common.cuh"

namespace {

constexpr int NT = SWEEP_NT;

// Rows of up to MAX_W cells: 64 chunks of 32, two a lane in the second
// phase of a scan (scan_phase2_wide).
constexpr int MAX_W = 2048;

// The row scans' shared buffers for `nr` rows of W cells.  P is W rounded
// up to 32 and K2 the power of two >= P / 32 (at most 64): a warp holds 32
// consecutive cells of a row in the first phase of a scan, or the K2 chunks
// of one column position in the second.  The [nr][K2][33] arrays hold cell
// 32 k + l at (q K2 + k) 33 + l, which neither phase reads with bank
// conflicts.
struct ScanBufs {
  float* row;       // [nr][W] the rows
  float* bt[2];     // [nr][K2][33] b of the forward and reverse scans
  float* runt[2];   // [nr][K2][33] `run` of both directions, as floats
  uint16_t* run;    // [2][nr][P] cells back to the last wall (forward) and
                    //   on to the next one (reverse), capped at MAX_W: a
                    //   scan's shifts stay below W <= MAX_W, and a run only
                    //   meets them in `run >= s`
  uint32_t* mask;   // [nr][MW] wall bits of each 32-cell chunk
  int mw;           // words a row of `mask`: max(32, K2)
};

// Rows over 1024 cells (WIDE) take the second phase two chunks a lane and
// a wall-bit row of K2 words; narrower ones keep 32 words a row, a
// constant, and no branch on the width in the scans.
template <bool WIDE>
__device__ __forceinline__ int mask_words(const ScanBufs& sb) {
  return WIDE ? sb.mw : 32;
}

__device__ __forceinline__ int tidx(int q, int c, int K2) {
  return (q * K2 + (c >> 5)) * 33 + (c & 31);
}

// Where each a-value of the scans comes from.  A cell is an affine-min map
// (a, b): walls (BIG, BIG), others (1, d), cells past either end (0, BIG).
// After the steps of shifts up to s/2 a cell's a is the sum of the a of the
// s cells ending (starting, going up) at it: a sum of ones (exact) clipped
// to the row, or BIG once a wall is among them.  So the step of shift s
// needs no a from other cells: it is BIG if the wall run-length `run` is
// below s, else min(s, cells left in the row).  The plain version sums the
// a-values step by step (fmm.py::_RowScan) and gets the same numbers.
__device__ __forceinline__ float step_a(float run, float s, float left) {
  return run >= s ? fminf(s, left) : BIG;
}

// The wall run-lengths of `nr` rows whose walls are in global memory at
// `wall` (pitch W): ballots give each 32-cell chunk's wall bits, then a
// cell finds the last (next) wall in its chunk or the chunks before
// (after).  Past W there are no walls, and a cell there has run 0.
template <bool WIDE>
__device__ void wall_runs(const uint8_t* wall, int nr, int W, int P,
                          int K2, const ScanBufs& sb) {
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < nr; ++q)
    for (int c = threadIdx.x; c < P; c += NT) {
      const unsigned m = __ballot_sync(0xffffffffu,
                                       c < W && wall[(size_t)q * W + c]);
      if (lane == 0) sb.mask[q * mask_words<WIDE>(sb) + c / 32] = m;
    }
  __syncthreads();
  const int K = P / 32;
  for (int q = 0; q < nr; ++q)
    for (int c = threadIdx.x; c < P; c += NT) {
      const int k = c >> 5, l = c & 31;
      const uint32_t* mk = sb.mask + q * mask_words<WIDE>(sb);
      int fwd = MAX_W, rev = MAX_W;
      if (c < W) {
        unsigned m = mk[k] & (0xffffffffu >> (31 - l));   // bits <= l
        int kk = k;
        while (!m && kk > 0) m = mk[--kk];
        if (m) fwd = imin(c - (32 * kk + 31 - __clz(m)), MAX_W);
        m = mk[k] & (0xffffffffu << l);                    // bits >= l
        kk = k;
        while (!m && kk < K - 1) m = mk[++kk];
        if (m) rev = imin(32 * kk + __ffs(m) - 1 - c, MAX_W);
      } else {
        fwd = rev = 0;
      }
      sb.run[q * P + c] = (uint16_t)fwd;
      sb.run[(nr + q) * P + c] = (uint16_t)rev;
      sb.runt[0][tidx(q, c, K2)] = (float)fwd;
      sb.runt[1][tidx(q, c, K2)] = (float)rev;
    }
  __syncthreads();
}

// Both segmented min-plus row scans of `nr` rows in `sb.row`: forward,
// then reverse over its result, each the Hillis-Steele steps of shift
// 1, 2, 4, ... < W of b[i] = min(b[i], b[i -+ s] + a[i]); `put` gets each
// cell's min(min(row, b_forward), b_reverse).
//   Phase 1, shifts below 32: a warp holds 32 consecutive cells of a row
// and shuffles.  A lane also carries the cell 32 before its own (after,
// going up): that cell's values after the shifts up to s/2 are right
// wherever its own cell reads them, since they depend only on the 31 cells
// before it, all in the warp's window.  So no barrier.
//   Phase 2, shifts of 32 and more: a group of K2 lanes holds one column
// position (the cell l of every 32-cell chunk k) and shuffles by chunks.
// A barrier after each phase.
template <int DIR>
__device__ void scan_phase1(int nr, int W, int P, int K2,
                            const ScanBufs& sb) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const uint16_t* run = sb.run + (DIR ? nr * P : 0);
  for (int q = 0; q < nr; ++q)
    for (int c = threadIdx.x; c < P; c += NT) {
      const float* rw = sb.row + (size_t)q * W;
      const int hc = DIR ? c + 32 : c - 32;          // the carried cell
      const bool c_in = c < W, h_in = hc >= 0 && hc < W;
      const float run_c = run[q * P + c];
      const float run_h = h_in ? run[q * P + hc] : 0.0f;
      // the reverse scan runs over the forward one's result
      float b = c_in ? rw[c] : BIG, hb = h_in ? rw[hc] : BIG;
      if (DIR) {
        if (c_in) b = fminf(b, sb.bt[0][tidx(q, c, K2)]);
        if (h_in) hb = fminf(hb, sb.bt[0][tidx(q, hc, K2)]);
      }
      b = run_c > 0.0f ? b : BIG;                    // run 0: a wall
      hb = run_h > 0.0f ? hb : BIG;
      const float left_c = DIR ? W - c : c + 1;
      const float left_h = DIR ? W - hc : hc + 1;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int from = DIR ? (lane + s) & 31 : (lane - s) & 31;
        const bool same = DIR ? lane + s < 32 : lane >= s;
        const float sb_ = __shfl_sync(full, b, from);
        const float shb = __shfl_sync(full, hb, from);
        b = fminf(b, (same ? sb_ : shb) + step_a(run_c, (float)s, left_c));
        hb = fminf(hb, (same ? shb : BIG) + step_a(run_h, (float)s, left_h));
      }
      sb.bt[DIR][tidx(q, c, K2)] = b;
    }
  __syncthreads();
}

template <int DIR>
__device__ void scan_phase2(int nr, int W, int P, int K2, int log_k2,
                            const ScanBufs& sb) {
  const unsigned full = 0xffffffffu;
  const int K = P / 32;
  for (int e = threadIdx.x; e < nr * 32 * K2; e += NT) {
    const int k = e & (K2 - 1), gl = e >> log_k2;
    const int l = gl & 31, q = gl >> 5;
    const int c = 32 * k + l, t = (q * K2 + k) * 33 + l;
    float b = k < K ? sb.bt[DIR][t] : BIG;
    const float run_c = k < K ? sb.runt[DIR][t] : 0.0f;
    const float left_c = DIR ? W - c : c + 1;
    for (int m = 1; 32 * m < W; m <<= 1) {
      const float n = DIR ? __shfl_down_sync(full, b, m, K2)
                          : __shfl_up_sync(full, b, m, K2);
      const bool has = DIR ? k + m < K2 : k >= m;
      b = fminf(b, (has ? n : BIG) + step_a(run_c, 32.0f * m, left_c));
    }
    if (k < K) sb.bt[DIR][t] = b;
  }
  __syncthreads();
}

// Phase 2 of rows over 1024 cells (K2 = 64): a warp holds one column
// position, lane k its chunks k and k + 32.  A step of m < 32 chunks reads
// lane k - m (k + m going up): the chunk it needs is in that lane's same
// register, or, across the middle, in its other one; the step of 32 chunks
// reads the lane's own other register.  Every cell still reads its
// neighbour's value from before the step, so the steps are phase 2's, one
// for one.
template <int DIR>
__device__ void scan_phase2_wide(int nr, int W, int P, const ScanBufs& sb) {
  const unsigned full = 0xffffffffu;
  const int K = P / 32;
  for (int e = threadIdx.x; e < nr * 32 * 32; e += NT) {
    const int k = e & 31, gl = e >> 5;
    const int l = gl & 31, q = gl >> 5;
    const int c0 = 32 * k + l, c1 = c0 + 1024;
    const int t0 = (q * 64 + k) * 33 + l, t1 = t0 + 32 * 33;
    const bool in1 = k + 32 < K;            // chunk k (< 32 < K) is real
    float b0 = sb.bt[DIR][t0];
    float b1 = in1 ? sb.bt[DIR][t1] : BIG;
    const float run0 = sb.runt[DIR][t0];
    const float run1 = in1 ? sb.runt[DIR][t1] : 0.0f;
    const float left0 = DIR ? W - c0 : c0 + 1;
    const float left1 = DIR ? W - c1 : c1 + 1;
    for (int m = 1; 32 * m < W; m <<= 1) {
      float n0, n1;
      if (m < 32) {
        const int from = DIR ? (k + m) & 31 : (k - m) & 31;
        const float s0 = __shfl_sync(full, b0, from);
        const float s1 = __shfl_sync(full, b1, from);
        const bool same = DIR ? k + m < 32 : k >= m;
        n0 = DIR ? (same ? s0 : s1) : (same ? s0 : BIG);
        n1 = DIR ? (same ? s1 : BIG) : (same ? s1 : s0);
      } else {
        n0 = DIR ? b1 : BIG;
        n1 = DIR ? BIG : b0;
      }
      b0 = fminf(b0, n0 + step_a(run0, 32.0f * m, left0));
      b1 = fminf(b1, n1 + step_a(run1, 32.0f * m, left1));
    }
    sb.bt[DIR][t0] = b0;
    if (in1) sb.bt[DIR][t1] = b1;
  }
  __syncthreads();
}

template <bool WIDE, typename Put>
__device__ void scan_rows(int nr, int W, int P, int K2, int log_k2,
                          const ScanBufs& sb, Put put) {
  scan_phase1<0>(nr, W, P, K2, sb);
  if constexpr (WIDE)
    scan_phase2_wide<0>(nr, W, P, sb);
  else
    scan_phase2<0>(nr, W, P, K2, log_k2, sb);
  scan_phase1<1>(nr, W, P, K2, sb);
  if constexpr (WIDE)
    scan_phase2_wide<1>(nr, W, P, sb);
  else
    scan_phase2<1>(nr, W, P, K2, log_k2, sb);
  for (int q = 0; q < nr; ++q)
    for (int c = threadIdx.x; c < W; c += NT) {
      const int t = tidx(q, c, K2);
      put(q, c, fminf(fminf(sb.row[(size_t)q * W + c], sb.bt[0][t]),
                      sb.bt[1][t]));
    }
}

// The shared-memory layout of a block, the same in every block of the
// cluster; block_sweep_smem_bytes is its size.
struct Layout {
  size_t RW, rows, P, K2, MW;
  __host__ __device__ Layout(int W, int rows_)
      : RW((size_t)rows_ * W), rows(rows_), P((W + 31) / 32 * 32), K2(1) {
    while (32 * K2 < P) K2 *= 2;
    MW = K2 > 32 ? K2 : 32;
  }
  // floats: buf0, buf1 (rows x W each), top, bottom (W each), the scans'
  // bt[2] and runt[2] (rows x K2 x 33 each); then the masks (rows x MW
  // words), the wall runs (2 x rows x P halfwords) and the walls (rows x W
  // bytes)
  __host__ __device__ size_t bytes(int W) const {
    return (2 * RW + 2 * (size_t)W + 4 * rows * K2 * 33) * 4 +
           rows * MW * 4 + 2 * rows * P * 2 + RW;
  }
};

template <bool WIDE>
__global__ void __launch_bounds__(NT, 1)
block_sweep_kernel(const float* __restrict__ d_in,
                   const uint8_t* __restrict__ wall,
                   float* __restrict__ d_out, int H, int W, int block,
                   int inner, int scan_chunk, int reverse, int rows) {
  extern __shared__ float smem[];
  const Cluster cl = cluster_init(block, rows);
  const int C = cl.size;
  const size_t plane = (size_t)H * W;
  const float* Din = d_in + cl.grid * plane;
  const uint8_t* wl_g = wall + cl.grid * plane;
  float* Dout = d_out + cl.grid * plane;

  const Layout L(W, rows);
  const int P = (int)L.P, K2 = (int)L.K2, log_k2 = __ffs(K2) - 1;
  float* buf0 = smem;                  // this block's rows, two buffers
  float* buf1 = buf0 + L.RW;
  float* top = buf1 + L.RW;            // the row above the row block
  float* bottom = top + W;             // the row below it
  ScanBufs sb;
  const size_t T = L.rows * K2 * 33;
  sb.bt[0] = bottom + W;
  sb.bt[1] = sb.bt[0] + T;
  sb.runt[0] = sb.bt[1] + T;
  sb.runt[1] = sb.runt[0] + T;
  sb.mask = reinterpret_cast<uint32_t*>(sb.runt[1] + T);
  sb.mw = (int)L.MW;
  sb.run = reinterpret_cast<uint16_t*>(sb.mask + L.rows * L.MW);
  uint8_t* wl = reinterpret_cast<uint8_t*>(sb.run + 2 * L.rows * P);
  // the neighbours' rows: the last row of the block above, the first of
  // the block below (only read where that neighbour owns them)
  const int up = imax(cl.rank - 1, 0), down = imin(cl.rank + 1, C - 1);
  const float* up0 = peer(buf0, up) + (size_t)(rows - 1) * W;
  const float* up1 = peer(buf1, up) + (size_t)(rows - 1) * W;
  const float* down0 = peer(buf0, down);
  const float* down1 = peer(buf1, down);

  for (int c = threadIdx.x; c < W; c += NT) top[c] = bottom[c] = BIG;

  const int nb = (H + block - 1) / block;
  for (int j = 0; j < nb; ++j) {
    const int k = reverse ? nb - 1 - j : j;
    const int r0 = k * block;
    const int R = imin(block, H - r0);
    // this block's rows of the row block: [lo, lo + nr)
    const int lo = cl.c0, nr = imax(0, imin(rows, R - lo));
    for (int q = 0; q < nr; ++q)
      for (int c = threadIdx.x; c < W; c += NT) {
        const size_t g = (size_t)(r0 + lo + q) * W + c;
        buf0[q * W + c] = Din[g];
        wl[q * W + c] = wl_g[g];
      }
    // the far boundary row, as it stands in the input field, to the block
    // that owns the row beside it; the near one is the carry
    if (nr > 0 && !reverse && lo + nr == R)
      for (int c = threadIdx.x; c < W; c += NT)
        bottom[c] = r0 + R < H ? Din[(size_t)(r0 + R) * W + c] : BIG;
    if (nr > 0 && reverse && lo == 0)
      for (int c = threadIdx.x; c < W; c += NT)
        top[c] = k > 0 ? Din[(size_t)(r0 - 1) * W + c] : BIG;
    // the walls' runs hold for the whole row block
    if (nr > 0 && inner > 0)
      wall_runs<WIDE>(wl_g + (size_t)(r0 + lo) * W, nr, W, P, K2, sb);
    cluster_barrier(C);  // every block's rows (and the carry) are in place

    int p = 0;           // the buffer that holds the current field
    for (int it = 0; it < inner / scan_chunk; ++it) {
      // both row scans of this block's rows, in place
      float* cur = p ? buf1 : buf0;
      if (nr > 0) {
        sb.row = cur;
        scan_rows<WIDE>(nr, W, P, K2, log_k2, sb,
                  [&](int q, int c, float v) { cur[q * W + c] = v; });
      }
      cluster_barrier(C);  // the neighbours' scanned rows are readable

      for (int pass = 0; pass < scan_chunk; ++pass) {
        const float* cu = p ? buf1 : buf0;
        float* nx = p ? buf0 : buf1;
        const float* above = p ? up1 : up0;
        const float* below = p ? down1 : down0;
        for (int q = 0; q < nr; ++q) {
          const int i = lo + q;            // the row within the row block
          const float* rw = cu + (size_t)q * W;
          const float* rup = q > 0 ? rw - W : i > 0 ? above : top;
          const float* rdn = q + 1 < nr ? rw + W : i + 1 < R ? below
                                                             : bottom;
          for (int c = threadIdx.x; c < W; c += NT) {
            const float lf = c > 0 ? rw[c - 1] : BIG;
            const float rt = c + 1 < W ? rw[c + 1] : BIG;
            const float cand = godunov(fminf(rup[c], rdn[c]), fminf(lf, rt));
            nx[q * W + c] = wl[q * W + c] ? BIG : fminf(rw[c], cand);
          }
        }
        // between two passes of a round: publishes this pass and frees the
        // buffer it read.  After a round's last pass the next round's scans
        // read only this block's rows of the buffer just written, and the
        // round's cluster barrier comes before any stencil reads or writes
        // again: a block barrier is enough.
        if (pass + 1 < scan_chunk)
          cluster_barrier(C);
        else
          __syncthreads();
        p ^= 1;
      }
    }
    // every stencil pass of the row block is done before the buffers and
    // the boundary rows are written again
    cluster_barrier(C);

    const float* res = p ? buf1 : buf0;
    for (int q = 0; q < nr; ++q)
      for (int c = threadIdx.x; c < W; c += NT)
        Dout[(size_t)(r0 + lo + q) * W + c] = res[q * W + c];
    // the carry: this row block's edge row on the side the sweep moves to,
    // into the boundary row of the block that owns the next block's row
    // beside it (block 0 going down; going up the next block is full)
    if (j + 1 < nb && nr > 0) {
      if (!reverse && lo + nr == R) {
        float* dst = peer(top, 0);
        for (int c = threadIdx.x; c < W; c += NT)
          dst[c] = res[(size_t)(nr - 1) * W + c];
      }
      if (reverse && lo == 0) {
        float* dst = peer(bottom, (block - 1) / rows);
        for (int c = threadIdx.x; c < W; c += NT) dst[c] = res[c];
      }
    }
    // res and the wall runs are read before the next block's load
    __syncthreads();
  }
  // no block leaves while a peer may still read its shared memory
  cluster_barrier(C);
}

}  // namespace

extern "C" size_t block_sweep_smem_bytes(int W, int rows) {
  return Layout(W, rows).bytes(W);
}

// Resident clusters of `cluster` blocks of `rows` rows each, into *out;
// returns the cudaError_t of the query.
extern "C" int block_sweep_max_clusters(int W, int rows, int cluster,
                                        int* out) {
  const size_t smem = block_sweep_smem_bytes(W, rows);
  return W > 1024
             ? max_active_clusters(block_sweep_kernel<true>, cluster, smem,
                                   out)
             : max_active_clusters(block_sweep_kernel<false>, cluster, smem,
                                   out);
}

// (B, H, W) float32 field, uint8 wall mask -> (B, H, W) float32 into d_out
// (which must not alias d_in), B clusters of `cluster` blocks, each owning
// `rows` rows of every row block (the launch plan's), rows of at most
// MAX_W cells.  Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int block_sweep_launch(const float* d_in, const uint8_t* wall,
                                  float* d_out, int B, int H, int W,
                                  int block, int inner, int scan_chunk,
                                  int reverse, int cluster, int rows,
                                  void* stream) {
  if (W > MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem = block_sweep_smem_bytes(W, rows);
  auto kernel =
      W > 1024 ? block_sweep_kernel<true> : block_sweep_kernel<false>;
  cudaError_t err = cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(B, cluster, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, d_in, wall, d_out, H, W, block,
                           inner, scan_chunk, reverse, rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
