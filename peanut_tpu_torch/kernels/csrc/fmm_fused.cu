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
// round costs one cluster barrier instead of one a pass.  Rows over 1024
// cells too wide for scan_chunk ghost rows a side in shared memory (past
// ~1600 cells at block 8) get fewer, S (the launch plan's `ghosts`): then
// every S passes of a round the blocks publish their own rows again as
// their peers' ghost rows, behind one more cluster barrier
// (ceil(scan_chunk / S) barriers a round).
// Splitting such rows by columns over the cluster instead, as B2 does,
// would split every row scan too: each of its ~12 Hillis-Steele steps a
// direction would cross blocks, one cluster barrier each.
//
// Races.  A block receives its ghost rows into one of two buffers, by the
// parity of the publication: a buffer is written again two publications
// later, by a peer that has passed the barrier its reader reached after
// reading it.
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
// time (past 2048 cells one a warp group), staged transposed in shared
// memory (walls !trav && !src) and scanned as lines of H cells by the same
// warp scans, a column a warp or group (fmm.py::_seg_scan_1d, dim -2).  The stencil and the scans keep the plain
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
// cells a group of G warps scans a line, 32 cells a lane each: a pair up to
// 2048 cells, four warps past it (one warp with 64 cells a lane would need
// 2 x 64 registers for the line alone, more than the 128 a thread has at
// 512 threads a block).
constexpr int MAX_LINE = 4096;
constexpr int XCH = 1024;               // floats of one exchange slot

// Warps of a line's group, and groups a block holds, for lines of n cells
__host__ __device__ inline int line_warps(int n) {
  return n <= 1024 ? 1 : n <= 2048 ? 2 : 4;
}
__host__ __device__ inline int line_groups(int n) {
  return NT / 32 / line_warps(n);
}

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

// A line of 1024 < n <= MAX_LINE cells scanned by a group of G warps:
// warp h of the group holds cells 1024 h + l + 32 k (k < 32) as one warp
// holds 1024, and runs the same Hillis-Steele steps.  A step's neighbours
// in another warp come through the group's exchange `x` (G - 1 slots of
// XCH floats of shared memory): the warps they come from (the senders)
// store the registers they are in, slot j of a holds a's at
// x[32 j + lane] and b's at x[XCH / 2 + 32 j + lane], and the warps that
// need them (the receivers) read them between two barriers of the group's
// 32 G threads (named barrier `id`).  A warp may be both: it stores its
// registers before the barrier and changes them only after it.
template <int G>
__device__ __forceinline__ void group_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(32 * G) : "memory");
}

struct GroupEdge {
  const float* x;
  bool recv;
  __device__ float a(int slot, int l) const {
    return recv ? x[32 * slot + l] : 0.0f;
  }
  __device__ float b(int slot, int l) const {
    return recv ? x[XCH / 2 + 32 * slot + l] : BIG;
  }
};

// Shifts below 1024: warp h's neighbours are the M = max(1, S / 32)
// registers of warp h - 1 (h + 1 reverse) nearest it (forward its last,
// reverse its first), which the sender stores in slot h (h - 1 reverse):
// slot j holds its register 32 - M + j forward, j reverse, which hs_step's
// slots address.  The first warp (the last, reverse) has the line's start
// beside it.
template <int G, int S, bool REVERSE>
__device__ __forceinline__ void group_step(float (&a)[32], float (&b)[32],
                                           int lane, int h, float* x,
                                           int id) {
  constexpr int M = S < 32 ? 1 : S / 32;
  static_assert(M <= XCH / 64, "a step's registers fit the exchange");
  // a pair has one slot, and one of its warps sends, the other receives
  const bool recv = REVERSE ? h + 1 < G : h > 0;
  const bool send = G == 2 ? !recv : REVERSE ? h > 0 : h + 1 < G;
  if (send) {
    float* xs = G == 2 ? x : x + (size_t)(REVERSE ? h - 1 : h) * XCH;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int k = REVERSE ? j : 32 - M + j;
      xs[32 * j + lane] = a[k];
      xs[XCH / 2 + 32 * j + lane] = b[k];
    }
  }
  group_bar<G>(id);
  const float* xr =
      G == 2 || !recv ? x : x + (size_t)(REVERSE ? h : h - 1) * XCH;
  hs_step<32, S, REVERSE>(a, b, lane, GroupEdge{xr, recv});
  group_bar<G>(id);
}

// Shift 1024 D (D = 1, 2): every cell's neighbour is the cell in the same
// register and lane of warp h - D (h + D reverse), or outside the line;
// the sender's 32 registers cross in two rounds of 16, through slot h
// (h - D reverse).
template <int G, int D, bool REVERSE>
__device__ __forceinline__ void group_far(float (&a)[32], float (&b)[32],
                                          int lane, int h, float* x,
                                          int id) {
  const bool recv = REVERSE ? h + D < G : h >= D;
  const bool send = G == 2 ? !recv : REVERSE ? h >= D : h + D < G;
  float* xs =
      G == 2 || !send ? x : x + (size_t)(REVERSE ? h - D : h) * XCH;
  const float* xr =
      G == 2 || !recv ? x : x + (size_t)(REVERSE ? h : h - D) * XCH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (send)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        xs[32 * j + lane] = a[16 * r + j];
        xs[XCH / 2 + 32 * j + lane] = b[16 * r + j];
      }
    group_bar<G>(id);
    if (recv)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = 16 * r + j;
        b[k] = fminf(b[k], xr[XCH / 2 + 32 * j + lane] + a[k]);
        a[k] = fminf(xr[32 * j + lane] + a[k], BIG);
      }
    group_bar<G>(id);
  }
  if (!recv)
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      b[k] = fminf(b[k], BIG + a[k]);
      a[k] = fminf(0.0f + a[k], BIG);
    }
}

template <int G, bool REVERSE>
__device__ __forceinline__ void group_line(float (&a)[32], float (&b)[32],
                                           int lane, int h, float* x,
                                           int id) {
  group_step<G, 1, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 2, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 4, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 8, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 16, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 32, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 64, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 128, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 256, REVERSE>(a, b, lane, h, x, id);
  group_step<G, 512, REVERSE>(a, b, lane, h, x, id);
  group_far<G, 1, REVERSE>(a, b, lane, h, x, id);
  if constexpr (G > 2) group_far<G, 2, REVERSE>(a, b, lane, h, x, id);
}

// Both scans of one line of n <= 1024 G cells (walls at `wline`), forward,
// then reverse, in place, by warp h of a group of G (exchange x, named
// barrier id), as warp_line_scans does them.  The warps past the line hold
// cells past its end, which change no cell of it.
template <int G>
__device__ void group_line_scans(float* line, const uint8_t* wline, int n,
                                 float* x, int id, int h) {
  const int lane = threadIdx.x & 31;
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
      group_line<G, false>(a, b, lane, h, x, id);
    else
      group_line<G, true>(a, b, lane, h, x, id);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int c = lane + 32 * k;
      if (c < nh) ln[c] = fminf(ln[c], b[k]);
    }
    __syncwarp();
  }
}

// A block's scans of `lines` lines of n cells at `line0 + i * pitch` (walls
// at `wall0 + i * pitch`), K cells a lane: a warp a line, or for K = 32 G
// (G = 2, 4) a group of G warps a line, the first `groups` groups of the
// block with the exchanges at `xch` (G - 1 slots of XCH floats a group).
template <int K>
__device__ __forceinline__ void block_line_scans(float* line0,
                                                 const uint8_t* wall0,
                                                 size_t pitch, int lines,
                                                 int n, float* xch,
                                                 int groups) {
  const int warp = threadIdx.x / 32;
  if constexpr (K > 32) {
    constexpr int G = K / 32;
    const int gi = warp / G, h = warp % G;
    if (gi < groups)
      for (int q = gi; q < lines; q += groups)
        group_line_scans<G>(line0 + q * pitch, wall0 + q * pitch, n,
                            xch + (size_t)gi * (G - 1) * XCH, 1 + gi, h);
  } else {
    for (int q = warp; q < lines; q += NT / 32)
      warp_line_scans<K>(line0 + q * pitch, wall0 + q * pitch, n);
  }
}

// The shared-memory layout of a block, the same in every block of the
// cluster.  The row phase and the column scans use the same memory in
// turn; fused_eikonal_smem_bytes is the larger of the two.  G rows hold a
// block's own rows and its ghost rows, S a side (the launch plan's ghost
// depth: min(scan_chunk, block) where the rows fit, fewer where not).
struct Layout {
  int W, H, seg, S, G, VC;
  size_t buf;   // floats of buf0 and of buf1
  __host__ __device__ Layout(int H_, int W_, int block, int seg_, int ghosts)
      : W(W_), H(H_), seg(seg_), S(ghosts), G(imin(block, seg_ + 2 * S)),
        VC(H_ > 2048 ? line_groups(H_) : VSCAN_COLS) {
    // G x W, and room for one group's exchange (the row scans keep it in
    // the other buffer)
    buf = (size_t)G * W;
    const size_t xch = (size_t)(line_warps(W) - 1) * XCH;
    if (buf < xch) buf = xch;
  }
  // floats: buf0, buf1, rcv0, rcv1 (2S x W: S slots above the own rows, S
  // below), top, bottom (W); the walls (G x W bytes)
  __host__ __device__ size_t row_bytes() const {
    const size_t w = W, g = G;
    return (2 * buf + 4 * (size_t)S * w + 2 * w) * 4 + g * w;
  }
  // VC columns of H cells and their walls, at a pitch of H + 1 (the
  // staging writes a row's columns to distinct banks): VSCAN_COLS, or past
  // 2048 cells a column a warp group; past 1024 cells the groups'
  // exchanges, 16-byte aligned
  __host__ __device__ size_t stage_bytes() const {
    return ((size_t)VC * (H + 1) * 5 + 15) / 16 * 16;
  }
  __host__ __device__ size_t col_bytes() const {
    return stage_bytes() +
           (H > 1024 ? (size_t)line_groups(H) * (line_warps(H) - 1) * XCH * 4
                     : 0);
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
                     int scan_chunk, int vscan, int seg, int ghosts) {
  extern __shared__ float smem[];
  const Cluster cl = cluster_init(block, seg);
  const int C = cl.size, lo = cl.c0;
  const size_t plane = (size_t)H * W;
  const uint8_t* tv = trav + cl.grid * plane;
  const uint8_t* sr = src + cl.grid * plane;
  float* D = out + cl.grid * plane;

  const Layout L(H, W, block, seg, ghosts);
  // the row phase
  float* buf0 = smem;                      // own and ghost rows, twice
  float* buf1 = buf0 + L.buf;
  float* rcv0 = buf1 + L.buf;              // ghost rows received, by parity
  float* rcv1 = rcv0 + 2 * (size_t)L.S * W;
  float* top = rcv1 + 2 * (size_t)L.S * W; // the row above the row block
  float* bottom = top + W;                 // the row below it
  uint8_t* wl = reinterpret_cast<uint8_t*>(bottom + W);   // walls, G rows
  // the column scans, in the same memory: a column to a warp (past 1024
  // cells to a group, their exchanges at cx); VC (= L.VC) columns a stage
  // and the column groups are constants of the instantiation
  constexpr int VC = KC > 64 ? NT / KC : VSCAN_COLS;
  constexpr int COL_GROUPS = KC > 32 ? NT / KC : 0;
  const int HP = H + 1;
  float* col = smem;
  uint8_t* cw = reinterpret_cast<uint8_t*>(col + (size_t)VC * HP);
  float* cx = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(smem) +
                                       ((size_t)VC * HP * 5 + 15) / 16 * 16);

  const int S = L.S;                       // ghost rows a side
  // passes between two refreshes of the ghost rows: a round's scan_chunk
  // where the ghost rows reach as far as its passes do, else S; only rows
  // over 1024 cells get fewer (the launch checks it)
  const int span = S < imin(scan_chunk, block) ? S : scan_chunk;
  // warp groups of rows over 1024 cells, their exchanges in the other
  // buffer
  const int row_groups =
      KR > 32 ? imin(NT / KR, (int)(L.buf / ((KR / 32 - 1) * XCH))) : 0;
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
      for (int c0 = cl.rank * cb; c0 < c_hi; c0 += VC) {
        const int nc = imin(VC, c_hi - c0);
        for (int e = threadIdx.x; e < nc * H; e += NT) {
          const int r = e / nc, q = e - r * nc;
          const size_t g = (size_t)r * W + c0 + q;
          col[q * HP + r] = __ldcg(D + g);
          cw[q * HP + r] = !tv[g] && !sr[g];
        }
        __syncthreads();
        block_line_scans<KC>(col, cw, HP, nc, H, cx, COL_GROUPS);
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
        // one span of a round: (scans at its start,) the own rows to the
        // peers, one cluster barrier, the ghost rows in, n passes
        auto span_passes = [&](int it, int s0, int n) {
          float* cur = p ? buf1 : buf0;
          float* rcv = par ? rcv1 : rcv0;
          if (nr > 0) {
            if (s0 == 0) {
              // a warp a row (rows over 1024 cells: a group, its exchange
              // in the other buffer, which the passes write before they
              // read)
              block_line_scans<KR>(cur + own, wl + own, W, nr, W,
                                   p ? buf0 : buf1, row_groups);
              __syncthreads();
            }
            // the own rows, scanned (or after s0 passes), to the peers that
            // hold them as ghost rows: slot i - lo2 + S above a peer's
            // rows, S + i - lo2 - nr2 below
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
          // the ghost rows are in place; at the row block's first barrier
          // the previous row block's rows are in the grid
          cluster_barrier(C);
          par ^= 1;
          if (nr == 0) return;
          if (it == 0 && s0 == 0) {
            if (glo == 0)
              for (int c = threadIdx.x; c < W; c += NT)
                top[c] = r0 > 0 ? __ldcg(D + (size_t)(r0 - 1) * W + c) : BIG;
            if (ghi == R)
              for (int c = threadIdx.x; c < W; c += NT)
                bottom[c] =
                    r0 + R < H ? __ldcg(D + (size_t)(r0 + R) * W + c) : BIG;
          }
          // the ghost rows, as their owners hold them
          for (int e = threadIdx.x; e < (lo - glo) * W; e += NT)
            cur[e] = rcv[(size_t)(glo - lo + S) * W + e];
          for (int e = threadIdx.x; e < (ghi - lo - nr) * W; e += NT)
            cur[own + (size_t)nr * W + e] = rcv[(size_t)S * W + e];
          __syncthreads();
          // pass s of the span reaches n - s rows beyond the own ones
          for (int s = 1; s <= n; ++s) {
            const int ext = imin(n - s, block);
            stencil_pass(p ? buf1 : buf0, p ? buf0 : buf1, wl, top, bottom,
                         imax(0, lo - ext), imin(R, lo + nr + ext), glo, ghi,
                         W);
            __syncthreads();
            p ^= 1;
          }
        };
        for (int it = 0; it < n_rounds; ++it) {
          if constexpr (KR > 32) {
            // rows over 1024 cells: spans of S passes where the plan gave
            // fewer ghost rows than the round's passes reach
            for (int s0 = 0; s0 < scan_chunk; s0 += span)
              span_passes(it, s0, imin(span, scan_chunk - s0));
          } else {
            span_passes(it, 0, scan_chunk);
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

// `ghosts` rows a side beside a block's `seg` rows (the launch plan's)
extern "C" size_t fused_eikonal_smem_bytes(int H, int W, int block, int seg,
                                           int ghosts) {
  return Layout(H, W, block, seg, ghosts).bytes();
}

// Cells a lane of a line of n cells: 16 up to 512, 32 up to 1024, 64 (a
// pair of warps, 32 each) up to 2048, 128 (four warps) up to MAX_LINE; 0
// past it.
static int lane_cells(int n) {
  return n <= 512    ? 16
         : n <= 1024 ? 32
         : n <= 2048 ? 64
         : n <= MAX_LINE ? 128 : 0;
}

template <typename F>
static int with_cells(int k, F f) {
  if (k == 16) return f(std::integral_constant<int, 16>());
  if (k == 32) return f(std::integral_constant<int, 32>());
  if (k == 64) return f(std::integral_constant<int, 64>());
  return f(std::integral_constant<int, 128>());
}

// f(KR, KC) for the kernel of (H, W) grids: KR from the rows' W cells, KC
// from the columns' H (the columns' scans run only with vscan).
template <typename F>
static int with_kernel(int H, int W, F f) {
  const int kr = lane_cells(W), kc = lane_cells(H);
  if (kr == 0 || kc == 0) return (int)cudaErrorInvalidValue;
  return with_cells(kc, [&](auto c) {
    return with_cells(kr, [&](auto r) { return f(r, c); });
  });
}

// Resident clusters of `cluster` blocks of `seg` rows each, into *out;
// returns the cudaError_t of the query.
extern "C" int fused_eikonal_max_clusters(int H, int W, int block, int seg,
                                          int ghosts, int cluster, int* out) {
  const size_t smem = fused_eikonal_smem_bytes(H, W, block, seg, ghosts);
  return with_kernel(H, W, [&](auto kr, auto kc) {
    return max_active_clusters(
        fused_eikonal_kernel<decltype(kr)::value, decltype(kc)::value>,
        cluster, smem, out);
  });
}

template <int KR, int KC>
static int launch(const uint8_t* trav, const uint8_t* src, float* out, int B,
                  int H, int W, int rounds, int block, int inner,
                  int scan_chunk, int vscan, int cluster, int seg, int ghosts,
                  cudaStream_t stream) {
  const size_t smem = fused_eikonal_smem_bytes(H, W, block, seg, ghosts);
  cudaError_t err = cluster_attributes(fused_eikonal_kernel<KR, KC>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fused_eikonal_kernel<KR, KC>, trav, src,
                           out, H, W, rounds, block, inner, scan_chunk, vscan,
                           seg, ghosts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// (B, H, W) uint8 traversible/source masks -> (B, H, W) float32 distances,
// +inf at walls and unreachable cells, B clusters of `cluster` blocks, each
// owning `seg` rows of every row block and holding `ghosts` rows a side
// beyond them (the launch plan's).  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int fused_eikonal_launch(const uint8_t* trav, const uint8_t* src,
                                    float* out, int B, int H, int W,
                                    int rounds, int block, int inner,
                                    int scan_chunk, int vscan, int cluster,
                                    int seg, int ghosts, void* stream) {
  const int full = imin(scan_chunk, block);
  if (ghosts < 1 || ghosts > full || (W <= 1024 && ghosts != full))
    return (int)cudaErrorInvalidValue;
  return with_kernel(H, W, [&](auto kr, auto kc) {
    return launch<decltype(kr)::value, decltype(kc)::value>(
        trav, src, out, B, H, W, rounds, block, inner, scan_chunk, vscan,
        cluster, seg, ghosts, (cudaStream_t)stream);
  });
}
