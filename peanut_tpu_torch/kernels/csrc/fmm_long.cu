// Long-line instantiations of the three eikonal kernels (sm_90a): the
// fused first-order solve (B1, fmm_fused.cu), the first-order block sweep
// (B4, fmm_sweep.cu) and the second-order one (B2, fmm_sweep2.cu), for the
// grids those kernels' shared memory or register scans do not hold: lines
// over 4096 cells (order 1: rows, and a fused solve's columns), rows past
// B1's shared memory with one ghost row a side, B2 rows past its shared
// memory at every cluster size.  The launch plan (fmm_sweep.py::sweep_plan,
// `long`) picks them only there; every shape of the serving tick, the
// single-env agent and the exact profile stays on the shared-memory kernels.
//
// Replaces the same TPU kernels as those files:
// peanut_tpu/kernels/fmm_fused.py::fused_eikonal (B1),
// fmm_pallas.py::pallas_block_sweep (B4) and pallas_block_sweep2 (B2).
//
// Design.  One thread-block cluster of C blocks per grid, as in the shared-
// memory kernels, but the row block's working buffers live in global
// memory (scratch the wrapper allocates; a 16-row block of 65,536 cells is
// 4 MB, which stays in the 50 MB L2).  All C x 512 threads of the cluster
// stride over the cells of a row block (or of the grid, for the column
// scans) with one fixed cell-to-thread mapping, and every step is the plain
// version's Jacobi step: read every cell's inputs from one buffer, write
// the other, then a cluster barrier.  The scans are the Hillis-Steele steps
// of fmm.py::_RowScan (shift 1, 2, 4, ... < the line), each carrying both
// halves of the affine-min map (a, b) from step to step exactly as the
// plain version does; the stencils are fmm.py::_Stencil and _order2_block.
// So the association and the arithmetic are the plain version's
// (fmm_common.cuh: godunov, godunov2, pick_dir) and the result is bit-equal
// to it.  A fused solve whose rows are short (a row block of at most
// SOLO_CELLS cells, e.g. tall narrow grids with column scans) runs its row
// sweeps on the cluster's first block alone with block barriers, and the
// column scans over the whole cluster.
//
// Bound.  The same bytes and operations as the shared-memory kernels.  What
// holds it is the chain of dependent steps, now log2(W) scan steps a scan
// (not two phases) each behind a cluster barrier and a round trip to L2.

#include "fmm_common.cuh"

namespace {

constexpr int NT = SWEEP_NT;

// Row blocks of at most this many cells run on one block of the cluster.
constexpr int SOLO_CELLS = 4 * NT;

// The threads that share a step: the whole cluster, or its first block.
struct Team {
  int t, n;       // this thread's index among the team's threads, their count
  int blocks;     // blocks in the team
  bool member;
};

__device__ __forceinline__ Team cluster_team() {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  Team tm;
  tm.blocks = (int)cl.num_blocks();
  tm.t = (int)cl.block_rank() * NT + threadIdx.x;
  tm.n = tm.blocks * NT;
  tm.member = true;
  return tm;
}

__device__ __forceinline__ Team solo_team() {
  Team tm;
  tm.blocks = 1;
  tm.t = threadIdx.x;
  tm.n = NT;
  tm.member = cooperative_groups::this_cluster().block_rank() == 0;
  return tm;
}

// Every team thread's global-memory writes before it are seen by every
// team thread after it.  Reads of the buffers go through L2 (__ldcg), so
// no block reads a stale line from its own L1.
__device__ __forceinline__ void team_sync(const Team& tm) {
  if (tm.blocks == 1) {
    __syncthreads();
  } else {
    __threadfence();
    cooperative_groups::this_cluster().sync();
  }
}

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// x = min(x, b), b the segmented min-plus scan of x along lines of `len`
// cells `stride` apart (the cell e sits at (e / stride) % len on its line):
// fmm.py::_RowScan, DIR 0 forward, 1 reverse.  b starts as x (BIG at
// walls) and a as 1 (BIG at walls); the step of shift s reads b and a of
// the cell s back (ahead) and writes b = min(b, b_back + a), a =
// min(a_back + a, BIG), the a read before the step, in the other buffer.
// Cells with no cell s back keep both.  Ends without a barrier: the caller
// reads x[e] only from e's own thread, or after one.
template <int DIR>
__device__ void line_scan(float* x, const uint8_t* wl, int N, int len,
                          int stride, float* b0, float* b1, float* a0,
                          float* a1, const Team& tm) {
  for (int e = tm.t; e < N; e += tm.n) {
    const bool w = wl[e];
    b0[e] = w ? BIG : ld(x + e);
    a0[e] = w ? BIG : 1.0f;
  }
  team_sync(tm);
  for (int s = 1; s < len; s <<= 1) {
    for (int e = tm.t; e < N; e += tm.n) {
      const int pos = (e / stride) % len;
      const bool has = DIR ? pos + s < len : pos >= s;
      const float a = ld(a0 + e);
      float b = ld(b0 + e), an = a;
      if (has) {
        const size_t o = DIR ? (size_t)e + (size_t)s * stride
                             : (size_t)e - (size_t)s * stride;
        b = fminf(b, ld(b0 + o) + a);
        an = fminf(ld(a0 + o) + a, BIG);
      }
      b1[e] = b;
      a1[e] = an;
    }
    team_sync(tm);
    float* t = b0; b0 = b1; b1 = t;
    t = a0; a0 = a1; a1 = t;
  }
  for (int e = tm.t; e < N; e += tm.n) x[e] = fminf(ld(x + e), ld(b0 + e));
}

// A first-order sweep's row-block buffers: the field twice (Jacobi) and
// the scans' b and a twice, `block` x W floats each.
struct Rows1 {
  float *f0, *f1, *b0, *b1, *a0, *a1;
};

__device__ __forceinline__ Rows1 rows1(float* s, size_t n) {
  return Rows1{s, s + n, s + 2 * n, s + 3 * n, s + 4 * n, s + 5 * n};
}

// One directed first-order block sweep of an H x W grid: fmm.py::_v_sweep,
// din -> dout (not aliased).  Per row block in sweep order, inner /
// scan_chunk rounds of both row scans and scan_chunk Jacobi Godunov
// passes; the near boundary row is the previous row block's result (in
// dout), the far one the input's row beside the block (BIG past the grid).
__device__ void sweep1(const float* din, const uint8_t* wall, float* dout,
                       int H, int W, int block, int inner, int scan_chunk,
                       int reverse, const Rows1& rb, const Team& tm) {
  const int nb = (H + block - 1) / block;
  for (int j = 0; j < nb; ++j) {
    const int k = reverse ? nb - 1 - j : j;
    const int r0 = k * block, R = imin(block, H - r0), n = R * W;
    const size_t g0 = (size_t)r0 * W;
    const uint8_t* wl = wall + g0;
    const float* top =
        r0 > 0 ? (reverse ? din : dout) + g0 - W : nullptr;
    const float* bottom =
        r0 + R < H ? (reverse ? dout : din) + g0 + n : nullptr;
    float *cur = rb.f0, *nxt = rb.f1;
    for (int e = tm.t; e < n; e += tm.n) cur[e] = ld(din + g0 + e);
    for (int it = 0; it < inner / scan_chunk; ++it) {
      line_scan<0>(cur, wl, n, W, 1, rb.b0, rb.b1, rb.a0, rb.a1, tm);
      line_scan<1>(cur, wl, n, W, 1, rb.b0, rb.b1, rb.a0, rb.a1, tm);
      team_sync(tm);     // the stencil reads the neighbours' scanned cells
      for (int pass = 0; pass < scan_chunk; ++pass) {
        for (int e = tm.t; e < n; e += tm.n) {
          const int q = e / W, c = e - q * W;
          const float up = q > 0 ? ld(cur + e - W)
                                 : top ? ld(top + c) : BIG;
          const float dn = q + 1 < R ? ld(cur + e + W)
                                     : bottom ? ld(bottom + c) : BIG;
          const float lf = c > 0 ? ld(cur + e - 1) : BIG;
          const float rt = c + 1 < W ? ld(cur + e + 1) : BIG;
          const float cand = godunov(fminf(up, dn), fminf(lf, rt));
          nxt[e] = wl[e] ? BIG : fminf(ld(cur + e), cand);
        }
        team_sync(tm);
        float* t = cur; cur = nxt; nxt = t;
      }
    }
    for (int e = tm.t; e < n; e += tm.n) dout[g0 + e] = ld(cur + e);
    // the next row block reads its carry from dout and rewrites the buffers
    team_sync(tm);
  }
}

// One directed second-order block sweep of an H x W grid:
// fmm.py::_v_sweep2, din -> dout (not aliased).  f0, f1: (block + 4) x W
// floats each, the row block between two context rows above and two below
// (rows r0 - 2, r0 - 1 and r0 + R, r0 + R + 1 of the grid: on the near side
// the previous row block's result in dout, on the far side the input; BIG
// past the grid), the same in both buffers.  `inner` Jacobi passes of the
// order-selecting update a row block.
__device__ void sweep2(const float* din, const uint8_t* wall,
                       const uint8_t* src, float* dout, int H, int W,
                       int block, int inner, int reverse, float* f0,
                       float* f1, const Team& tm) {
  const int nb = (H + block - 1) / block;
  for (int j = 0; j < nb; ++j) {
    const int k = reverse ? nb - 1 - j : j;
    const int r0 = k * block, R = imin(block, H - r0), n = R * W;
    const size_t g0 = (size_t)r0 * W;
    const uint8_t* wl = wall + g0;
    const uint8_t* sr = src + g0;
    for (int e = tm.t; e < (R + 4) * W; e += tm.n) {
      const int r = e / W, c = e - r * W;      // row r of the buffer
      const int row = r0 - 2 + r;
      float v;
      if (r >= 2 && r < R + 2)
        v = ld(din + (size_t)row * W + c);
      else if (row < 0 || row >= H)
        v = BIG;
      else   // above: near going down, far going up; below the other way
        v = ld(((r < 2) != (reverse != 0) ? dout : din) +
               (size_t)row * W + c);
      f0[e] = v;
      f1[e] = v;
    }
    team_sync(tm);
    float *cur = f0, *nxt = f1;
    for (int it = 0; it < inner; ++it) {
      for (int e = tm.t; e < n; e += tm.n) {
        const int r = e / W, c = e - r * W;
        const float* row = cur + (size_t)(r + 2) * W;
        const float up2 = ld(row - 2 * W + c), up1 = ld(row - W + c);
        const float mid = ld(row + c);
        const float dn1 = ld(row + W + c), dn2 = ld(row + 2 * W + c);
        const float lf1 = c >= 1 ? ld(row + c - 1) : BIG;
        const float lf2 = c >= 2 ? ld(row + c - 2) : BIG;
        const float rt1 = c + 1 < W ? ld(row + c + 1) : BIG;
        const float rt2 = c + 2 < W ? ld(row + c + 2) : BIG;
        float u1y, u2y, u1x, u2x;
        pick_dir(up1, up2, dn1, dn2, &u1y, &u2y);
        pick_dir(lf1, lf2, rt1, rt2, &u1x, &u2x);
        const float cand = godunov2(u1x, u2x, u1y, u2y);
        const float out = sr[e] ? 0.0f : fminf(mid, cand);
        nxt[(size_t)(r + 2) * W + c] = wl[e] ? BIG : out;
      }
      team_sync(tm);
      float* t = cur; cur = nxt; nxt = t;
    }
    for (int e = tm.t; e < n; e += tm.n)
      dout[g0 + e] = ld(cur + 2 * (size_t)W + e);
    team_sync(tm);
  }
}

__global__ void __launch_bounds__(NT, 1)
sweep_long_kernel(const float* __restrict__ d_in,
                  const uint8_t* __restrict__ wall, float* __restrict__ d_out,
                  float* __restrict__ scratch, int H, int W, int block,
                  int inner, int scan_chunk, int reverse) {
  const Team tm = cluster_team();
  const int grid = blockIdx.x / tm.blocks;
  const size_t plane = (size_t)H * W, rbn = (size_t)block * W;
  sweep1(d_in + grid * plane, wall + grid * plane, d_out + grid * plane, H,
         W, block, inner, scan_chunk, reverse,
         rows1(scratch + grid * 6 * rbn, rbn), tm);
}

__global__ void __launch_bounds__(NT, 1)
sweep2_long_kernel(const float* __restrict__ d_in,
                   const uint8_t* __restrict__ wall,
                   const uint8_t* __restrict__ src, float* __restrict__ d_out,
                   float* __restrict__ scratch, int H, int W, int block,
                   int inner, int reverse) {
  const Team tm = cluster_team();
  const int grid = blockIdx.x / tm.blocks;
  const size_t plane = (size_t)H * W, buf = (size_t)(block + 4) * W;
  float* f0 = scratch + grid * 2 * buf;
  sweep2(d_in + grid * plane, wall + grid * plane, src + grid * plane,
         d_out + grid * plane, H, W, block, inner, reverse, f0, f0 + buf,
         tm);
}

// Floats of a fused solve's scratch a grid: the second field, the row
// sweeps' Rows1 and the column scans' b and a twice (in the Rows1 b/a
// space where that is the larger).
__host__ __device__ inline size_t fused_long_floats(int H, int W, int block,
                                                    int vscan) {
  const size_t plane = (size_t)H * W, rbn = (size_t)block * W;
  const size_t ba = vscan && plane > rbn ? plane : rbn;
  return plane + 2 * rbn + 4 * ba;
}

// fmm_fused.py::fused_eikonal_reference: field 0 at sources and BIG
// elsewhere, rounds x { column scans (vscan); down sweep; up sweep }, +inf
// where the field is >= BIG / 2.  The field lives in `out` and a second
// one in the scratch (each sweep reads one and writes the other).
__global__ void __launch_bounds__(NT, 1)
fused_long_kernel(const uint8_t* __restrict__ trav,
                  const uint8_t* __restrict__ src, float* __restrict__ out,
                  float* __restrict__ scratch, uint8_t* __restrict__ walls,
                  int H, int W, int rounds, int block, int inner,
                  int scan_chunk, int vscan) {
  const Team tm = cluster_team();
  const int grid = blockIdx.x / tm.blocks;
  const size_t plane = (size_t)H * W, rbn = (size_t)block * W;
  const int N = H * W;
  float* d = out + grid * plane;
  uint8_t* wl = walls + grid * plane;
  float* s = scratch + grid * fused_long_floats(H, W, block, vscan);
  float* d2 = s;
  const size_t ba = vscan && plane > rbn ? plane : rbn;
  float *b0 = s + plane + 2 * rbn, *b1 = b0 + ba, *a0 = b1 + ba,
        *a1 = a0 + ba;
  const Rows1 rb{s + plane, s + plane + rbn, b0, b1, a0, a1};
  const Team row_team = rbn <= (size_t)SOLO_CELLS ? solo_team() : tm;
  const uint8_t* tv = trav + grid * plane;
  const uint8_t* sc = src + grid * plane;
  for (int e = tm.t; e < N; e += tm.n) {
    d[e] = sc[e] ? 0.0f : BIG;
    wl[e] = !tv[e] && !sc[e];
  }
  team_sync(tm);
  for (int r = 0; r < rounds; ++r) {
    if (vscan) {
      line_scan<0>(d, wl, N, H, W, b0, b1, a0, a1, tm);
      line_scan<1>(d, wl, N, H, W, b0, b1, a0, a1, tm);
      team_sync(tm);
    }
    if (row_team.member) {
      sweep1(d, wl, d2, H, W, block, inner, scan_chunk, 0, rb, row_team);
      sweep1(d2, wl, d, H, W, block, inner, scan_chunk, 1, rb, row_team);
    }
    if (row_team.blocks != tm.blocks) team_sync(tm);
  }
  for (int e = tm.t; e < N; e += tm.n) {
    const float v = ld(d + e);
    d[e] = v >= HALF_BIG ? __int_as_float(0x7f800000) : v;
  }
}

template <typename K, typename... Args>
int launch(K kernel, int grids, int cluster, void* stream, Args... args) {
  cudaError_t err = cluster_attributes(kernel, 0);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(grids, cluster, 0, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Resident clusters of `cluster` blocks of the long-line kernels (a block
// an SM, as the shared-memory kernels reserve), into *out.
extern "C" int long_max_clusters(int cluster, int* out) {
  return max_active_clusters(sweep_long_kernel, cluster, 0, out);
}

// Scratch floats a grid: B4 6 x block x W, B2 2 x (block + 4) x W, B1
// fused_long_floats (and H x W bytes of walls).
extern "C" size_t block_sweep_long_floats(int W, int block) {
  return 6 * (size_t)block * W;
}

extern "C" size_t block_sweep2_long_floats(int W, int block) {
  return 2 * (size_t)(block + 4) * W;
}

extern "C" size_t fused_eikonal_long_floats(int H, int W, int block,
                                            int vscan) {
  return fused_long_floats(H, W, block, vscan);
}

// The launches: B clusters of `cluster` blocks, on `stream`; each returns
// the cudaError_t of the launch.  Arguments as the shared-memory kernels'
// (fmm_sweep.cu, fmm_sweep2.cu, fmm_fused.cu) with the scratch in place of
// the segment.
extern "C" int block_sweep_long_launch(const float* d_in, const uint8_t* wall,
                                       float* d_out, float* scratch, int B,
                                       int H, int W, int block, int inner,
                                       int scan_chunk, int reverse,
                                       int cluster, void* stream) {
  return launch(sweep_long_kernel, B, cluster, stream, d_in, wall, d_out,
                scratch, H, W, block, inner, scan_chunk, reverse);
}

extern "C" int block_sweep2_long_launch(const float* d_in,
                                        const uint8_t* wall,
                                        const uint8_t* src, float* d_out,
                                        float* scratch, int B, int H, int W,
                                        int block, int inner, int reverse,
                                        int cluster, void* stream) {
  return launch(sweep2_long_kernel, B, cluster, stream, d_in, wall, src,
                d_out, scratch, H, W, block, inner, reverse);
}

extern "C" int fused_eikonal_long_launch(const uint8_t* trav,
                                         const uint8_t* src, float* out,
                                         float* scratch, uint8_t* walls,
                                         int B, int H, int W, int rounds,
                                         int block, int inner, int scan_chunk,
                                         int vscan, int cluster,
                                         void* stream) {
  return launch(fused_long_kernel, B, cluster, stream, trav, src, out,
                scratch, walls, H, W, rounds, block, inner, scan_chunk,
                vscan);
}
