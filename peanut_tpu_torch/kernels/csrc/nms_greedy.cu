// Greedy NMS over a suppression matrix: a pack into bits, then one warp's
// walk per problem (sm_90a).
//
// Takes the place of the convergence loop in the JAX package's
// peanut_tpu/models/boxes.py::nms_fixed, a lax.while_loop of bounding rounds
// that XLA runs on the device (no Pallas kernel).  In eager PyTorch the same
// loop needs a host sync per convergence check, which holds the calling
// thread until the stream drains; these kernels end the solve on the device.
//
// Per problem, in score order: sup (n, n) bytes, sup[i][j] != 0 when the
// higher-scored box i overlaps box j past the threshold, and valid (n,)
// bytes.  Output keep (n,) bytes, the unique solution of
//     keep[j] = valid[j] && !any_{i<j}(keep[i] && sup[i][j]),
// which is greedy NMS and the fixed point that the bounding rounds reach.
// Only the strict upper triangle of sup is read.
//
// Design.  The walk is a chain: box j's fate depends on every kept box
// before it.  So everything that needs no decision is taken off it.
//   1. nms_pack, many blocks, a warp a row: row j of sup becomes NWP words
//      of bits (bit c of word w: column 32 w + c > j is suppressed by j),
//      read as 4 bytes a lane (128 bytes a warp), only the spans right of
//      the diagonal, the 8 nibbles of a word joined by three shuffles.
//   2. nms_walk, a block per problem.  Its warps copy the problem's packed
//      rows into shared memory (all of them where they fit, n up to ~1300)
//      and turn valid into the `alive` words.  Then one warp walks word by
//      word, lane l holding alive words l and l + 32 in registers: word
//      w's alive bits (one shuffle) are final for every box whose
//      suppressors all lie in earlier words, so the lowest alive bit is
//      kept; its row's word w (one shared-memory broadcast) clears the
//      later boxes it suppresses in that word, and each lane clears its
//      own words from the same row, off the chain.  A box that is not kept
//      costs nothing; a kept one costs one shared-memory read, an and-not
//      and a find-first-set on the chain; a word costs one shuffle.  No
//      device-memory read is on the chain.  Where the rows do not fit, the
//      other warps stream them through a ring of 8-row tiles in order
//      (cp.async, NSTAGE tiles ahead), which needs no decision either; the
//      alive words stay in shared memory there, and a tile costs two block
//      barriers.
//
// Bound (as chip_smoke.py counts it): bytes = valid + keep + the sup rows
// of the kept boxes right of the diagonal, the only part the answer
// depends on, at 3.35 TB/s.  What holds the kernel is the chain; its floor
// (chip_smoke.py's nms_chain probe, nms_chain_loop below) prices n steps
// of one shuffle and one dependent shared-memory read, and the pack reads
// the upper triangle once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PACK_WARPS = 8;       // rows a pack block takes at once
constexpr int WALK_THREADS = 256;
constexpr int WALK_WARPS = WALK_THREADS / 32;
constexpr int TILE_ROWS = 8;        // rows a ring tile holds
constexpr int NSTAGE = 4;           // ring tiles
constexpr size_t SMEM_MAX = 232448;

__host__ __device__ inline int words(int n) { return (n + 31) >> 5; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
// row pitch in words: 16-byte rows for cp.async
__host__ __device__ inline int pitch(int n) { return (words(n) + 3) & ~3; }

// ---- 1. pack -------------------------------------------------------------

__global__ void __launch_bounds__(32 * PACK_WARPS)
    nms_pack(const uint8_t* __restrict__ sup, uint32_t* __restrict__ bits,
             int problems, int n) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * PACK_WARPS + (threadIdx.x >> 5);
  if (row >= (long long)problems * n) return;
  const int j = (int)(row % n);
  const int P = pitch(n);
  const uint8_t* src = sup + row * n;
  uint32_t* dst = bits + row * P;
  // words wholly at or left of the diagonal: no bits
  const int s0 = (j + 1) >> 7;                 // first 128-column span read
  for (int w = lane; w < 4 * s0 && w < P; w += 32) dst[w] = 0u;
  // a lane reads 4 columns of a span; word-aligned rows take one load
  const bool aligned = ((reinterpret_cast<uintptr_t>(src)) & 3) == 0;
  const int spans = P / 4;
#pragma unroll 4
  for (int s = s0; s < spans; ++s) {
    const int c = 128 * s + 4 * lane;
    uint32_t q = 0;                            // the 4 bytes, one per byte
    if (aligned && c + 3 < n) {
      q = *reinterpret_cast<const uint32_t*>(src + c);
    } else {
      for (int k = 0; k < 4; ++k)
        if (c + k < n && src[c + k]) q |= 0xffu << (8 * k);
    }
    uint32_t nib = 0;
    for (int k = 0; k < 4; ++k)
      nib |= (((q >> (8 * k)) & 0xffu) != 0u && c + k > j && c + k < n)
                 ? 1u << k : 0u;
    uint32_t v = nib << (4 * (lane & 7));
    v |= __shfl_xor_sync(0xffffffffu, v, 1);
    v |= __shfl_xor_sync(0xffffffffu, v, 2);
    v |= __shfl_xor_sync(0xffffffffu, v, 4);
    if ((lane & 7) == 0) dst[4 * s + (lane >> 3)] = v;
  }
}

// ---- 2. walk -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Does word w of the walk: the alive bits of boxes 32 w .. 32 w + 31 whose
// rows `row(j)` returns (shared memory), in order; updates `alive` right
// of w (lane-owned words) and returns the final keep word.  Only the bits
// in `span` are walked (the rows in shared memory now).
template <typename Row>
__device__ __forceinline__ uint32_t walk_bits(uint32_t aw, uint32_t span,
                                              int w, int NW, uint32_t* alive,
                                              Row row) {
  const int lane = threadIdx.x & 31;
  uint32_t todo = aw & span;
  while (todo) {
    const int b = __ffs(todo) - 1;
    const uint32_t* r = row(32 * w + b);
    const uint32_t rw = r[w];          // one broadcast read: on the chain
    todo &= todo - 1;
    todo &= ~rw;
    aw &= ~rw;
    for (int wd = w + 1 + lane; wd < NW; wd += 32) alive[wd] &= ~r[wd];
  }
  return aw;
}

// The walk over rows resident in shared memory, by one warp: lane l holds
// the alive words l and l + 32 (WPL of them) in registers.  Word w's fate
// is one shuffle; a kept box's row clears its word w (one broadcast read,
// the chain) and every lane's words (a read each, off the chain: nothing
// waits for it until the next word's shuffle).  Words left of a row's
// diagonal are zero, so every lane may apply every row.  The final alive
// words, the keep set, go back to `alive`.
template <int WPL>
__device__ __forceinline__ void walk_resident(const uint32_t* rows,
                                              uint32_t* alive, int P,
                                              int NW) {
  const int lane = threadIdx.x & 31;
  uint32_t al[WPL];
#pragma unroll
  for (int i = 0; i < WPL; ++i)
    al[i] = lane + 32 * i < NW ? alive[lane + 32 * i] : 0u;
  for (int w = 0; w < NW; ++w) {
    uint32_t todo = __shfl_sync(0xffffffffu,
                                WPL == 1 || w < 32 ? al[0] : al[WPL - 1],
                                w & 31);
    while (todo) {
      const int b = __ffs(todo) - 1;
      const uint32_t* r = rows + (size_t)(32 * w + b) * P;
      const uint32_t rw = r[w];
#pragma unroll
      for (int i = 0; i < WPL; ++i)
        if (lane + 32 * i < NW) al[i] &= ~r[lane + 32 * i];
      todo &= todo - 1;
      todo &= ~rw;
    }
  }
#pragma unroll
  for (int i = 0; i < WPL; ++i)
    if (lane + 32 * i < NW) alive[lane + 32 * i] = al[i];
}

__global__ void __launch_bounds__(WALK_THREADS)
    nms_walk(const uint32_t* __restrict__ bits,
             const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
             int n, int resident) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int NW = words(n), P = pitch(n);
  const size_t prob = blockIdx.x;
  bits += prob * n * P;
  valid += prob * n;
  keep += prob * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* alive = smem;                  // P words
  uint32_t* rows = smem + P;               // n x P (resident) or the ring

  for (int w = warp; w < NW; w += WALK_WARPS) {
    const int c = 32 * w + lane;
    const uint32_t m = __ballot_sync(0xffffffffu, c < n && valid[c] != 0);
    if (lane == 0) alive[w] = m;
  }
  if (resident) {
    const int chunks = n * P / 4;          // 16-byte chunks
    for (int e = threadIdx.x; e < chunks; e += WALK_THREADS)
      cp_async16(rows + 4 * (size_t)e, bits + 4 * (size_t)e);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      if (NW <= 32)
        walk_resident<1>(rows, alive, P, NW);
      else
        walk_resident<2>(rows, alive, P, NW);
    }
  } else {
    // the ring: tile t (rows 8 t .. 8 t + 7) in stage t % NSTAGE
    const int tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
    const int tile_chunks = TILE_ROWS * P / 4;
    auto load = [&](int t) {
      if (t < tiles) {
        uint32_t* dst = rows + (size_t)(t % NSTAGE) * TILE_ROWS * P;
        const uint32_t* src = bits + (size_t)t * TILE_ROWS * P;
        const int ch = imin(tile_chunks, (n - t * TILE_ROWS) * P / 4);
        for (int e = threadIdx.x; e < ch; e += WALK_THREADS)
          cp_async16(dst + 4 * (size_t)e, src + 4 * (size_t)e);
      }
      cp_async_commit();                   // an empty group past the end
    };
    for (int t = 0; t < NSTAGE - 1; ++t) load(t);
    __syncthreads();                       // alive is written
    uint32_t aw = 0;
    for (int t = 0; t < tiles; ++t) {
      load(t + NSTAGE - 1);                // its stage was read at t - 1
      cp_async_wait<NSTAGE - 1>();         // tile t has landed (this thread)
      __syncthreads();                     // ... for every thread
      if (warp == 0) {
        const int w = t * TILE_ROWS / 32, sh = t * TILE_ROWS % 32;
        if (sh == 0) aw = alive[w];
        const uint32_t* base = rows + (size_t)(t % NSTAGE) * TILE_ROWS * P;
        auto row = [&](int j) {
          return base + (size_t)(j - t * TILE_ROWS) * P;
        };
        aw = walk_bits(aw, 0xffu << sh, w, NW, alive, row);
        __syncwarp();
        if (lane == 0 && (sh + TILE_ROWS == 32 || t + 1 == tiles))
          alive[w] = aw;
        __syncwarp();
      }
      __syncthreads();                     // stage t % NSTAGE is free
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += WALK_THREADS)
    keep[j] = (alive[j >> 5] >> (j & 31)) & 1u;
}

// ---- the chain probe -----------------------------------------------------

// One warp, `steps` dependent steps of one shuffle and one shared-memory
// read whose address depends on it: what a walk step costs at the least.
__global__ void nms_chain_kernel(int steps, uint32_t* out) {
  __shared__ uint32_t tab[1024];
  for (int i = threadIdx.x; i < 1024; i += 32) tab[i] = (i * 7 + 3) & 1023;
  __syncwarp();
  uint32_t x = threadIdx.x;
  for (int i = 0; i < steps; ++i)
    x = tab[(__shfl_sync(0xffffffffu, x, i & 31) + i) & 1023];
  out[threadIdx.x] = x;
}

}  // namespace

// Shared memory of the walk and whether the rows stay resident.
extern "C" size_t nms_walk_smem_bytes(int n, int* resident) {
  const size_t P = pitch(n);
  const size_t all = (P + (size_t)n * P) * 4;
  *resident = all <= SMEM_MAX;
  return *resident ? all : (P + (size_t)NSTAGE * TILE_ROWS * P) * 4;
}

// Words of a packed problem: n rows of pitch(n) words.
extern "C" size_t nms_packed_words(int n) { return (size_t)n * pitch(n); }

// The pack alone: sup (problems, n, n) bytes into bits (problems x
// nms_packed_words(n) words).  Returns the cudaError_t of the launch.
extern "C" int nms_pack_launch(const void* sup, void* bits, int problems,
                               int n, void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  const long long rows = (long long)problems * n;
  nms_pack<<<(unsigned)((rows + PACK_WARPS - 1) / PACK_WARPS),
             32 * PACK_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sup), static_cast<uint32_t*>(bits),
      problems, n);
  return (int)cudaGetLastError();
}

// sup (problems, n, n), valid (problems, n), keep (problems, n): bytes;
// bits: scratch of problems x nms_packed_words(n) words.  The pack, then
// the walk.  Returns the cudaError_t of the launches.
extern "C" int nms_greedy_launch(const void* sup, const void* valid,
                                 void* keep, void* bits, int problems, int n,
                                 void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = (cudaError_t)nms_pack_launch(sup, bits, problems, n,
                                                 stream);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  const size_t smem = nms_walk_smem_bytes(n, &resident);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(nms_walk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_walk<<<problems, WALK_THREADS, smem, st>>>(
      static_cast<const uint32_t*>(bits), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, resident);
  return (int)cudaGetLastError();
}

// The chain probe: one warp, `steps` steps, into out (32 words).
extern "C" int nms_chain_loop(int steps, void* out, void* stream) {
  nms_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
