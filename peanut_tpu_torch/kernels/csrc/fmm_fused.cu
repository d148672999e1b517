// Whole first-order eikonal solve, one thread-block cluster per grid
// (sm_90a).
//
// Replaces the TPU kernel peanut_tpu/kernels/fmm_fused.py::fused_eikonal
// (body _fused_kernel, helpers _relax_block, _seg_scan_lr, vscan_chunks).
// Computes what it computes: `rounds` times { optional column min-plus
// scans; a down pass and an up pass over `block`-row blocks }, each row
// block relaxed by inner/scan_chunk rounds of { segmented row min-plus
// scans in both directions; scan_chunk Jacobi Godunov passes } against its
// boundary rows.  Down pass: top = the previous row block's relaxed last
// row (carried), bottom = the next row block's first row as it stands.  Up
// pass: bottom = the next row block's relaxed first row (carried), top =
// the previous row block's last row as it stands.  Walls are BIG; a source
// on a wall is a source.  The last row block may be ragged (482 = 30 x 16
// + 2): rows past H do not exist and the boundary beyond them is BIG, which
// is what the TPU kernel's wall padding amounts to.
//
// Design.  A cluster of C CUDA blocks per grid; C and the rows each block
// owns come from the launch plan (fmm_sweep.py::sweep_plan with `fused`).
// The grid lives in global memory (the output buffer, L2-resident at
// 16 x 482^2 x 4 B); the cluster barrier (barrier.cluster arrive.release /
// wait.acquire) orders the blocks' writes and reads of it.  As in the block
// sweep (fmm_sweep.cu), the cluster splits every row block by rows: block q
// owns the rows [q * seg, q * seg + seg) of each row block and scans them
// alone, whole, in the plain version's association.  Unlike there, a warp
// scans a whole row in registers (hs_step), so a block's few rows scan side
// by side without block barriers (B4's block-wide scans take a block's
// rows one after another, all warps on each), and a block also holds the
// scan_chunk rows beyond its own on each side (ghost rows, clipped to the
// row block).  After a round's scans each block stores its scanned rows
// into the shared memory of the peers that hold them as ghost rows (DSMEM
// stores, which need not be waited for), and after the round's cluster
// barrier runs the round's scan_chunk Jacobi passes alone, pass k over its
// own rows and scan_chunk - k ghost rows a side, with block barriers.  A
// ghost row is computed from the same inputs by the same arithmetic as its
// owner computes it, so it holds the owner's values bit for bit, and a
// round costs one cluster barrier instead of one a pass.
//
// Races.  A block receives its ghost rows into one of two buffers, by the
// parity of the round: a buffer is written again two rounds later, by a
// peer that has passed the barrier its reader reached after reading it.
// The carried boundary row is the previous row block's edge row in the grid,
// which its owner wrote before the barrier that ends the first round's
// scans; the row "as it stands" is read after that barrier too, and its
// owner rewrites it only after the next row block's first barrier, which
// the reader reaches after its read.  So a row block needs no barrier of
// its own, and neither do the passes and rounds (without column scans).
// The column scans (vscan) read every row of the grid and write a band of
// columns: a barrier before and after them.  Blocks without rows in a
// ragged row block still reach every barrier, and a last barrier keeps
// every block alive while a peer may read its shared memory.
//
// Column scans.  Block q takes a band of ceil(W / C) columns, 16 at a
// time, staged transposed in shared memory (walls !trav && !src) and
// scanned as lines of H cells by the same warp scans, a column a warp
// (fmm.py::_seg_scan_1d, dim -2).  The stencil and the scans keep the plain
// version's arithmetic (fmm_common.cuh: fma1, a correctly rounded sqrtf),
// so the result equals the plain PyTorch version
// (fmm_fused.py::fused_eikonal_reference) bit for bit.
//
// Bound (as chip_smoke.py counts it).  Bytes: read trav+src (2 B/cell),
// write the field (4 B/cell): 16 x 482^2 x 6 B = 22 MB -> 6.7 us at
// 3.35 TB/s.  Work: every row is relaxed 2 x rounds times, each time with
// inner stencil passes (17 operations/cell) and 2 x inner/chunk sequential
// min-plus scans (3 operations/cell): 16 x 482^2 x 2 x 2 x (17 x 40 +
// 6 x 10) = 1.1e10 operations -> 0.16 ms at 67 TFLOP/s fp32.  What holds
// it is the chain: ceil(H/block) row blocks x 2 passes x rounds x
// inner/scan_chunk scan rounds (1240 at the 16 x 482^2 blanket, 2880 at the
// 8 x 480^2 column-scan solve), each a block's row scans, the ghost rows'
// stores, one cluster barrier (~0.7 us on the H100,
// scripts/torch_sweep_breakdown.py) and scan_chunk local passes, which
// with the ghost rows do twice the own rows' work at the blanket: ~9.2 us
// a round there on the H100, ~3.1 of it the scans, the stores and the
// barrier (chip_smoke.py's kernel_breakdown).

#include "fmm_common.cuh"

#include <type_traits>

namespace {

constexpr int NT = SWEEP_NT;
constexpr int VSCAN_COLS = NT / 32;   // columns a column-scan step stages
// Lines (rows, and columns with vscan) of up to MAX_LINE cells.  Past 1024
// cells a pair of warps scans a line, 32 cells a lane each (one warp with
// 64 cells a lane would need 2 x 64 registers for the line alone, more
// than the 128 a thread has at 512 threads a block).
constexpr int MAX_LINE = 2048;
constexpr int PAIRS = NT / 64;          // warp pairs a block
constexpr int XCH = 1024;               // floats of a pair's exchange

// The values of a neighbour outside a warp's KW registers: one warp holds
// the whole line, so the neighbour is before its start (after its end):
// (0, BIG).
struct LineEdge {
  __device__ float a(int, int) const { return 0.0f; }
  __device__ float b(int, int) const { return BIG; }
};

// One forward (reverse) Hillis-Steele step of shift S over a line held in
// registers by one warp: lane l owns cells c = l + 32 k, k < KW.  Cells
// past the line are (0, BIG); a neighbour outside the registers comes from
// `e`: e.a(slot, lane), e.b(slot, lane), slot 0 at lane `src` for shifts
// below 32, else slot k (k + M - KW reverse) at the own lane.  Shifts below
// 32 read other lanes through shuffles, larger ones other registers of the
// same lane; either way every cell reads its neighbour's value from before
// the step.  The arithmetic is the plain version's (fmm.py::_RowScan).
template <int KW, int S, bool REVERSE, typename Edge = LineEdge>
__device__ __forceinline__ void hs_step(float (&a)[KW], float (&b)[KW],
                                        int lane, const Edge& e = Edge()) {
  if constexpr (S < 32) {
    const unsigned full = 0xffffffffu;
    const int src = REVERSE ? (lane + S) & 31 : (lane - S) & 31;
    const bool same_k = REVERSE ? lane + S < 32 : lane >= S;
    // a cell whose neighbour is in the other lane's next (previous)
    // register: walk the registers so that it is read before it changes
    float sa = __shfl_sync(full, a[REVERSE ? 0 : KW - 1], src);
    float sb = __shfl_sync(full, b[REVERSE ? 0 : KW - 1], src);
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = REVERSE ? i : KW - 1 - i;
      const int kn = REVERSE ? k + 1 : k - 1;
      const bool kn_ok = REVERSE ? kn < KW : kn >= 0;
      const float na = kn_ok ? __shfl_sync(full, a[kn_ok ? kn : 0], src)
                             : e.a(0, src);
      const float nb = kn_ok ? __shfl_sync(full, b[kn_ok ? kn : 0], src)
                             : e.b(0, src);
      const float a_n = same_k ? sa : na;
      const float b_n = same_k ? sb : nb;
      b[k] = fminf(b[k], b_n + a[k]);
      a[k] = fminf(a_n + a[k], BIG);
      sa = na;
      sb = nb;
    }
  } else {
    constexpr int M = S / 32;
    // update in the order that reads every neighbour before it changes
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const int k = REVERSE ? i : KW - 1 - i;
      const int kn = REVERSE ? k + M : k - M;
      const bool ok = REVERSE ? kn < KW : kn >= 0;
      const int slot = REVERSE ? kn - KW : k;
      const float a_n = ok ? a[ok ? kn : 0] : e.a(slot, lane);
      const float b_n = ok ? b[ok ? kn : 0] : e.b(slot, lane);
      b[k] = fminf(b[k], b_n + a[k]);
      a[k] = fminf(a_n + a[k], BIG);
    }
  }
}

template <int KW, bool REVERSE>
__device__ __forceinline__ void hs_line(float (&a)[KW], float (&b)[KW],
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
  if constexpr (KW > 32) hs_step<KW, 1024, REVERSE>(a, b, lane);
}

// Both scans of one line of n <= 32 KW cells (walls at `wline`), forward,
// then reverse over its result, in place, by one warp in registers, so a
// block scans its lines side by side without block barriers.  Steps with
// shifts >= n change nothing, so running all log2(32 KW) of them equals the
// plain version's `while s < n` loop.
template <int KW>
__device__ void warp_line_scans(float* line, const uint8_t* wline, int n) {
  const int lane = threadIdx.x & 31;
  for (int dir = 0; dir < 2; ++dir) {
    float a[KW], b[KW];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int c = lane + 32 * k;
      const bool real = c < n;
      const bool w = real && wline[c];
      a[k] = real ? (w ? BIG : 1.0f) : 0.0f;
      b[k] = real ? (w ? BIG : line[c]) : BIG;
    }
    if (dir == 0)
      hs_line<KW, false>(a, b, lane);
    else
      hs_line<KW, true>(a, b, lane);
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int c = lane + 32 * k;
      if (c < n) line[c] = fminf(line[c], b[k]);
    }
    __syncwarp();
  }
}

// A line of 1024 < n <= 2048 cells scanned by a pair of warps: warp h of
// the pair holds cells 1024 h + l + 32 k (k < 32) as one warp holds 1024,
// and runs the same Hillis-Steele steps.  A step's neighbours in the other
// half come through the pair's exchange `x` (XCH floats of shared memory):
// the half they come from (the sender: the lower half forward, the upper
// reverse) stores the registers they are in, slot j of a holds a's at
// x[32 j + lane] and b's at x[XCH / 2 + 32 j + lane], and the other half
// (the receiver) reads them between two barriers of the pair's 64 threads
// (named barrier `id`).
__device__ __forceinline__ void pair_bar(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

struct PairEdge {
  const float* x;
  bool recv;
  __device__ float a(int slot, int l) const {
    return recv ? x[32 * slot + l] : 0.0f;
  }
  __device__ float b(int slot, int l) const {
    return recv ? x[XCH / 2 + 32 * slot + l] : BIG;
  }
};

// Shifts below 1024: the sender's M = max(1, S / 32) registers nearest the
// receiver (forward its last, reverse its first) are the receiver's
// neighbours: slot j holds the sender's register 32 - M + j forward, j
// reverse, which hs_step's slots address.
template <int S, bool REVERSE>
__device__ __forceinline__ void pair_step(float (&a)[32], float (&b)[32],
                                          int lane, bool recv, float* x,
                                          int id) {
  constexpr int M = S < 32 ? 1 : S / 32;
  static_assert(M <= XCH / 64, "a step's registers fit the exchange");
  if (!recv)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int k = REVERSE ? j : 32 - M + j;
      x[32 * j + lane] = a[k];
      x[XCH / 2 + 32 * j + lane] = b[k];
    }
  pair_bar(id);
  hs_step<32, S, REVERSE>(a, b, lane, PairEdge{x, recv});
  pair_bar(id);
}

// Shift 1024: every receiver cell's neighbour is the sender's cell in the
// same register and lane, every sender cell's is outside the line; the
// sender's 32 registers cross in two rounds of 16.
template <bool REVERSE>
__device__ __forceinline__ void pair_last(float (&a)[32], float (&b)[32],
                                          int lane, bool recv, float* x,
                                          int id) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!recv)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        x[32 * j + lane] = a[16 * r + j];
        x[XCH / 2 + 32 * j + lane] = b[16 * r + j];
      }
    pair_bar(id);
    if (recv)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = 16 * r + j;
        b[k] = fminf(b[k], x[XCH / 2 + 32 * j + lane] + a[k]);
        a[k] = fminf(x[32 * j + lane] + a[k], BIG);
      }
    pair_bar(id);
  }
  if (!recv)
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      b[k] = fminf(b[k], BIG + a[k]);
      a[k] = fminf(0.0f + a[k], BIG);
    }
}

template <bool REVERSE>
__device__ __forceinline__ void pair_line(float (&a)[32], float (&b)[32],
                                          int lane, bool recv, float* x,
                                          int id) {
  pair_step<1, REVERSE>(a, b, lane, recv, x, id);
  pair_step<2, REVERSE>(a, b, lane, recv, x, id);
  pair_step<4, REVERSE>(a, b, lane, recv, x, id);
  pair_step<8, REVERSE>(a, b, lane, recv, x, id);
  pair_step<16, REVERSE>(a, b, lane, recv, x, id);
  pair_step<32, REVERSE>(a, b, lane, recv, x, id);
  pair_step<64, REVERSE>(a, b, lane, recv, x, id);
  pair_step<128, REVERSE>(a, b, lane, recv, x, id);
  pair_step<256, REVERSE>(a, b, lane, recv, x, id);
  pair_step<512, REVERSE>(a, b, lane, recv, x, id);
  pair_last<REVERSE>(a, b, lane, recv, x, id);
}

// Both scans of one line of n <= 2048 cells (walls at `wline`), forward,
// then reverse, in place, by the pair of warps 2 pr, 2 pr + 1 of the block
// (exchange x, named barrier 1 + pr), as warp_line_scans does them.
__device__ void pair_line_scans(float* line, const uint8_t* wline, int n,
                                float* x, int pr) {
  const int lane = threadIdx.x & 31, h = (threadIdx.x >> 5) & 1;
  float* ln = line + 1024 * h;
  const uint8_t* wl = wline + 1024 * h;
  const int nh = n - 1024 * h;
  for (int dir = 0; dir < 2; ++dir) {
    float a[32], b[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int c = lane + 32 * k;
      const bool real = c < nh;
      const bool w = real && wl[c];
      a[k] = real ? (w ? BIG : 1.0f) : 0.0f;
      b[k] = real ? (w ? BIG : ln[c]) : BIG;
    }
    if (dir == 0)
      pair_line<false>(a, b, lane, h == 1, x, 1 + pr);
    else
      pair_line<true>(a, b, lane, h == 0, x, 1 + pr);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int c = lane + 32 * k;
      if (c < nh) ln[c] = fminf(ln[c], b[k]);
    }
    __syncwarp();
  }
}

// A block's scans of `lines` lines of n cells at `line0 + i * pitch` (walls
// at `wall0 + i * pitch`), K cells a lane: a warp a line, or for K = 64 a
// pair of warps a line, the first `pairs` pairs of the block with the
// exchanges at `xch` (XCH floats a pair).
template <int K>
__device__ __forceinline__ void block_line_scans(float* line0,
                                                 const uint8_t* wall0,
                                                 size_t pitch, int lines,
                                                 int n, float* xch,
                                                 int pairs) {
  const int warp = threadIdx.x / 32;
  if constexpr (K == 64) {
    const int pr = warp / 2;
    if (pr < pairs)
      for (int q = pr; q < lines; q += pairs)
        pair_line_scans(line0 + q * pitch, wall0 + q * pitch, n,
                        xch + (size_t)pr * XCH, pr);
  } else {
    for (int q = warp; q < lines; q += NT / 32)
      warp_line_scans<K>(line0 + q * pitch, wall0 + q * pitch, n);
  }
}

// The shared-memory layout of a block, the same in every block of the
// cluster.  The row phase and the column scans use the same memory in
// turn; fused_eikonal_smem_bytes is the larger of the two.  G rows hold a
// block's own rows and its ghost rows, S a side.
struct Layout {
  int W, H, seg, S, G;
  __host__ __device__ Layout(int H_, int W_, int block, int seg_, int chunk)
      : W(W_), H(H_), seg(seg_), S(imin(chunk, block)),
        G(imin(block, seg_ + 2 * S)) {}
  // floats: buf0, buf1 (G x W), rcv0, rcv1 (2S x W: S slots above the own
  // rows, S below), top, bottom (W); the walls (G x W bytes)
  __host__ __device__ size_t row_bytes() const {
    const size_t w = W, g = G;
    return (2 * g * w + 4 * (size_t)S * w + 2 * w) * 4 + g * w;
  }
  // VSCAN_COLS columns of H cells and their walls, at a pitch of H + 1
  // (the staging writes a row's columns to distinct banks); past 1024
  // cells the warp pairs' exchanges
  __host__ __device__ size_t col_bytes() const {
    return (size_t)VSCAN_COLS * (H + 1) * 5 +
           (H > 1024 ? (size_t)PAIRS * XCH * 4 : 0);
  }
  __host__ __device__ size_t bytes() const {
    const size_t r = row_bytes(), c = col_bytes();
    return r > c ? r : c;
  }
};

// One Jacobi pass over the rows [a, b) of a row block whose rows from glo
// to ghi are held in `cu` (pitch W), into `nx`.  Rows 0 and R - 1 read the
// fixed boundary rows `top` and `bottom`; a pass never reaches another row
// outside [glo, ghi).  A thread takes a column and walks its rows with the
// values above, at and below the cell in registers; the rows' updates are
// independent, so the unrolled walk overlaps their loads and arithmetic.
__device__ void stencil_pass(const float* cu, float* nx, const uint8_t* wl,
                             const float* top, const float* bottom, int a,
                             int b, int glo, int ghi, int W) {
  for (int c = threadIdx.x; c < W; c += NT) {
    const bool has_lf = c > 0, has_rt = c + 1 < W;
    int l = (a - glo) * W + c;
    float up = a > glo ? cu[l - W] : top[c];
    float mid = cu[l];
#pragma unroll 4
    for (int i = a; i < b; ++i, l += W) {
      const float dn = i + 1 < ghi ? cu[l + W] : bottom[c];
      const float lf = has_lf ? cu[l - 1] : BIG;
      const float rt = has_rt ? cu[l + 1] : BIG;
      const float cand = godunov(fminf(up, dn), fminf(lf, rt));
      nx[l] = wl[l] ? BIG : fminf(mid, cand);
      up = mid;
      mid = dn;
    }
  }
}

// KR cells a lane scan the rows (W <= 32 KR), KC the columns (H <= 32 KC)
template <int KR, int KC>
__global__ void __launch_bounds__(NT, 1)
fused_eikonal_kernel(const uint8_t* __restrict__ trav,
                     const uint8_t* __restrict__ src, float* __restrict__ out,
                     int H, int W, int rounds, int block, int inner,
                     int scan_chunk, int vscan, int seg) {
  extern __shared__ float smem[];
  const Cluster cl = cluster_init(block, seg);
  const int C = cl.size, lo = cl.c0;
  const size_t plane = (size_t)H * W;
  const uint8_t* tv = trav + cl.grid * plane;
  const uint8_t* sr = src + cl.grid * plane;
  float* D = out + cl.grid * plane;

  const Layout L(H, W, block, seg, scan_chunk);
  // the row phase
  float* buf0 = smem;                      // own and ghost rows, twice
  float* buf1 = buf0 + (size_t)L.G * W;
  float* rcv0 = buf1 + (size_t)L.G * W;    // ghost rows received, by parity
  float* rcv1 = rcv0 + 2 * (size_t)L.S * W;
  float* top = rcv1 + 2 * (size_t)L.S * W; // the row above the row block
  float* bottom = top + W;                 // the row below it
  uint8_t* wl = reinterpret_cast<uint8_t*>(bottom + W);   // walls, G rows
  // the column scans, in the same memory: a column to a warp (past 1024
  // cells to a pair, their exchanges at cx)
  const int HP = H + 1;
  float* col = smem;
  uint8_t* cw = reinterpret_cast<uint8_t*>(col + (size_t)VSCAN_COLS * HP);
  float* cx = reinterpret_cast<float*>(cw + (size_t)VSCAN_COLS * HP);

  const int S = L.S;                       // ghost rows a side
  const int n_rounds = inner / scan_chunk;
  const int nb = (H + block - 1) / block;
  auto owned = [&](int r) {
    const int i = r % block;
    return i >= lo && i < lo + seg;
  };

  for (int r = 0; r < H; ++r)
    if (owned(r))
      for (int c = threadIdx.x; c < W; c += NT) {
        const size_t g = (size_t)r * W + c;
        D[g] = sr[g] ? 0.0f : BIG;
      }
  __syncthreads();

  int par = 0;            // the published buffer of the next scan round
  for (int rd = 0; rd < rounds; ++rd) {
    if (vscan) {
      cluster_barrier(C);   // every row of the grid is written
      const int cb = (W + C - 1) / C;
      const int c_hi = imin(W, (cl.rank + 1) * cb);
      for (int c0 = cl.rank * cb; c0 < c_hi; c0 += VSCAN_COLS) {
        const int nc = imin(VSCAN_COLS, c_hi - c0);
        for (int e = threadIdx.x; e < nc * H; e += NT) {
          const int r = e / nc, q = e - r * nc;
          const size_t g = (size_t)r * W + c0 + q;
          col[q * HP + r] = __ldcg(D + g);
          cw[q * HP + r] = !tv[g] && !sr[g];
        }
        __syncthreads();
        block_line_scans<KC>(col, cw, HP, nc, H, cx, PAIRS);
        __syncthreads();
        for (int e = threadIdx.x; e < nc * H; e += NT) {
          const int r = e / nc, q = e - r * nc;
          D[(size_t)r * W + c0 + q] = col[q * HP + r];
        }
        __syncthreads();    // the lines are read before the next stage
      }
      cluster_barrier(C);   // every band is back in the grid
    }
    for (int pass = 0; pass < 2; ++pass)
      for (int j = 0; j < nb; ++j) {
        const int k = pass ? nb - 1 - j : j;
        const int r0 = k * block, R = imin(block, H - r0);
        // own rows [lo, lo + nr), held with the ghost rows [glo, ghi)
        const int nr = imax(0, imin(seg, R - lo));
        const int glo = imax(0, lo - S), ghi = imin(R, lo + nr + S);
        const size_t own = (size_t)(lo - glo) * W;
        if (nr > 0) {
          for (int e = threadIdx.x; e < nr * W; e += NT)
            buf0[own + e] = __ldcg(D + (size_t)(r0 + lo) * W + e);
          for (int e = threadIdx.x; e < (ghi - glo) * W; e += NT) {
            const size_t g = (size_t)(r0 + glo) * W + e;
            wl[e] = !tv[g] && !sr[g];
          }
        }
        __syncthreads();

        int p = 0;          // the buffer that holds the current rows
        for (int it = 0; it < n_rounds; ++it, par ^= 1) {
          float* cur = p ? buf1 : buf0;
          float* rcv = par ? rcv1 : rcv0;
          if (nr > 0) {
            // a warp a row (rows over 1024 cells: a pair, its exchange in
            // the other buffer, which the passes write before they read)
            block_line_scans<KR>(cur + own, wl + own, W, nr, W,
                                 p ? buf0 : buf1,
                                 imin(PAIRS, L.G * W / XCH));
            __syncthreads();
            // the scanned rows to the peers that hold them as ghost rows:
            // slot i - lo2 + S above a peer's rows, S + i - lo2 - nr2 below
            for (int q2 = 0; q2 < C; ++q2) {
              const int lo2 = q2 * seg, nr2 = imax(0, imin(seg, R - lo2));
              if (q2 == cl.rank || nr2 == 0) continue;
              const bool above = q2 > cl.rank;
              const int a = above ? imax(lo, lo2 - S) : lo;
              const int b = above ? lo + nr : imin(lo + nr, lo2 + nr2 + S);
              const int slot = above ? S - lo2 : S - lo2 - nr2;
              float* dst = peer(rcv, q2);
              for (int i = a; i < b; ++i)
                for (int c = threadIdx.x; c < W; c += NT)
                  dst[(size_t)(slot + i) * W + c] =
                      cur[own + (size_t)(i - lo) * W + c];
            }
          }
          // the round's ghost rows are in place; at the first round the
          // previous row block's rows are in the grid
          cluster_barrier(C);
          if (nr == 0) continue;
          if (it == 0) {
            if (glo == 0)
              for (int c = threadIdx.x; c < W; c += NT)
                top[c] = r0 > 0 ? __ldcg(D + (size_t)(r0 - 1) * W + c) : BIG;
            if (ghi == R)
              for (int c = threadIdx.x; c < W; c += NT)
                bottom[c] =
                    r0 + R < H ? __ldcg(D + (size_t)(r0 + R) * W + c) : BIG;
          }
          // the ghost rows, as their owners scanned them
          for (int e = threadIdx.x; e < (lo - glo) * W; e += NT)
            cur[e] = rcv[(size_t)(glo - lo + S) * W + e];
          for (int e = threadIdx.x; e < (ghi - lo - nr) * W; e += NT)
            cur[own + (size_t)nr * W + e] = rcv[(size_t)S * W + e];
          __syncthreads();
          // pass s reaches scan_chunk - s rows beyond the own ones
          for (int s = 1; s <= scan_chunk; ++s) {
            const int ext = imin(scan_chunk - s, block);
            stencil_pass(p ? buf1 : buf0, p ? buf0 : buf1, wl, top, bottom,
                         imax(0, lo - ext), imin(R, lo + nr + ext), glo, ghi,
                         W);
            __syncthreads();
            p ^= 1;
          }
        }
        if (nr > 0) {
          const float* res = (p ? buf1 : buf0) + own;
          for (int e = threadIdx.x; e < nr * W; e += NT)
            D[(size_t)(r0 + lo) * W + e] = res[e];
        }
        __syncthreads();    // the buffers are read before the next loads
      }
  }
  // every row is final; no block leaves while a peer may read its shared
  // memory
  cluster_barrier(C);
  for (int r = 0; r < H; ++r)
    if (owned(r))
      for (int c = threadIdx.x; c < W; c += NT) {
        const size_t g = (size_t)r * W + c;
        if (__ldcg(D + g) >= HALF_BIG) D[g] = __int_as_float(0x7f800000);
      }
}

}  // namespace

extern "C" size_t fused_eikonal_smem_bytes(int H, int W, int block, int seg,
                                           int scan_chunk) {
  return Layout(H, W, block, seg, scan_chunk).bytes();
}

// Cells a lane of a line of n cells: 16 up to 512, 32 up to 1024, 64 (a
// pair of warps, 32 each) up to MAX_LINE; 0 past it.
static int lane_cells(int n) {
  return n <= 512 ? 16 : n <= 1024 ? 32 : n <= MAX_LINE ? 64 : 0;
}

// f(KR, KC) for the kernel of (H, W) grids: KR from the rows' W cells, KC
// from the columns' H (the columns' scans run only with vscan).
template <typename F>
static int with_kernel(int H, int W, F f) {
  const int kr = lane_cells(W), kc = lane_cells(H);
  auto rows = [&](auto c) {
    if (kr == 16) return f(std::integral_constant<int, 16>(), c);
    if (kr == 32) return f(std::integral_constant<int, 32>(), c);
    return f(std::integral_constant<int, 64>(), c);
  };
  if (kr == 0 || kc == 0) return (int)cudaErrorInvalidValue;
  if (kc == 16) return rows(std::integral_constant<int, 16>());
  if (kc == 32) return rows(std::integral_constant<int, 32>());
  return rows(std::integral_constant<int, 64>());
}

// Resident clusters of `cluster` blocks of `seg` rows each, into *out;
// returns the cudaError_t of the query.
extern "C" int fused_eikonal_max_clusters(int H, int W, int block, int seg,
                                          int scan_chunk, int cluster,
                                          int* out) {
  const size_t smem = fused_eikonal_smem_bytes(H, W, block, seg, scan_chunk);
  return with_kernel(H, W, [&](auto kr, auto kc) {
    return max_active_clusters(
        fused_eikonal_kernel<decltype(kr)::value, decltype(kc)::value>,
        cluster, smem, out);
  });
}

template <int KR, int KC>
static int launch(const uint8_t* trav, const uint8_t* src, float* out, int B,
                  int H, int W, int rounds, int block, int inner,
                  int scan_chunk, int vscan, int cluster, int seg,
                  cudaStream_t stream) {
  const size_t smem = fused_eikonal_smem_bytes(H, W, block, seg, scan_chunk);
  cudaError_t err = cluster_attributes(fused_eikonal_kernel<KR, KC>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fused_eikonal_kernel<KR, KC>, trav, src,
                           out, H, W, rounds, block, inner, scan_chunk, vscan,
                           seg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// (B, H, W) uint8 traversible/source masks -> (B, H, W) float32 distances,
// +inf at walls and unreachable cells, B clusters of `cluster` blocks, each
// owning `seg` rows of every row block (the launch plan's).  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int fused_eikonal_launch(const uint8_t* trav, const uint8_t* src,
                                    float* out, int B, int H, int W,
                                    int rounds, int block, int inner,
                                    int scan_chunk, int vscan, int cluster,
                                    int seg, void* stream) {
  return with_kernel(H, W, [&](auto kr, auto kc) {
    return launch<decltype(kr)::value, decltype(kc)::value>(
        trav, src, out, B, H, W, rounds, block, inner, scan_chunk, vscan,
        cluster, seg, (cudaStream_t)stream);
  });
}
