// Greedy NMS over a suppression matrix, one CUDA block per problem (sm_90a).
//
// Takes the place of the convergence loop in the JAX package's
// peanut_tpu/models/boxes.py::nms_fixed, a lax.while_loop of bounding rounds
// that XLA runs on the device (no Pallas kernel).  In eager PyTorch the same
// loop needs a host sync per convergence check, which holds the calling
// thread until the stream drains; this kernel ends the solve on the device.
//
// Per problem, in score order: sup (n, n) bytes, sup[i][j] != 0 when the
// higher-scored box i overlaps box j past the threshold, and valid (n,)
// bytes.  Output keep (n,) bytes, the unique solution of
//     keep[j] = valid[j] && !any_{i<j}(keep[i] && sup[i][j]),
// which is greedy NMS and the fixed point that the bounding rounds reach.
// Only the strict upper triangle of sup is read.
//
// Design.  The block walks j in order, with the suppressed set as a bitmask
// in shared memory.  Whether j is kept depends only on that mask and valid
// (also in shared memory), so every thread decides it alike and the
// branch is uniform.  A kept j ORs row j of sup into the mask: each warp
// takes 32-column words of the row, one coalesced byte per lane and a
// ballot per word.  Boxes that are not kept cost one shared-memory read.
//
// Bound (as chip_smoke.py counts it): bytes = valid + keep + the sup rows
// of the kept boxes right of the diagonal, the only part the answer
// depends on, at 3.35 TB/s.  The walk is a chain of n dependent steps, so
// the kernel runs far above that bound; it exists to keep the host free.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    nms_greedy_kernel(const uint8_t* __restrict__ sup,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int n) {
  extern __shared__ uint32_t smem[];
  const int words = (n + 31) >> 5;
  uint32_t* removed = smem;                                  // words
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(smem + words);  // n
  const size_t prob = blockIdx.x;
  sup += prob * n * n;
  valid += prob * n;
  keep += prob * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int WARPS = THREADS / 32;

  for (int w = threadIdx.x; w < words; w += THREADS) removed[w] = 0u;
  for (int j = threadIdx.x; j < n; j += THREADS) s_valid[j] = valid[j];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const bool k =
        s_valid[j] != 0 && ((removed[j >> 5] >> (j & 31)) & 1u) == 0u;
    if (threadIdx.x == 0) keep[j] = k ? 1 : 0;
    if (!k) continue;  // uniform: every thread read the same mask
    __syncthreads();   // all reads of the mask for this j are done
    const uint8_t* row = sup + static_cast<size_t>(j) * n;
    for (int w = (j >> 5) + warp; w < words; w += WARPS) {
      const int c = (w << 5) + lane;
      const bool s = c > j && c < n && row[c] != 0;
      const uint32_t m = __ballot_sync(0xffffffffu, s);
      if (lane == 0 && m) removed[w] |= m;
    }
    __syncthreads();   // the new mask is seen by the next j
  }
}

size_t smem_bytes(int n) {
  return static_cast<size_t>((n + 31) >> 5) * 4 + static_cast<size_t>(n);
}

}  // namespace

extern "C" size_t nms_greedy_smem_bytes(int n) { return smem_bytes(n); }

// sup (problems, n, n), valid (problems, n), keep (problems, n): bytes.
extern "C" int nms_greedy_launch(const void* sup, const void* valid,
                                 void* keep, int problems, int n,
                                 void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  // the caller keeps smem_bytes(n) within the default 48 KB
  nms_greedy_kernel<<<problems, THREADS, smem_bytes(n),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sup), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n);
  return static_cast<int>(cudaGetLastError());
}
