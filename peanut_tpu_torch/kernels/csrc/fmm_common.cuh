// Device code shared by the eikonal kernels: the fused solve (fmm_fused.cu,
// B1) and the two directed block sweeps (fmm_sweep.cu, B4; fmm_sweep2.cu,
// B2).
//
// The arithmetic helpers are the plain version's (fmm.py::_godunov, _fma):
// the one multiply-add of an update rounded once (fma1), a correctly
// rounded sqrtf and nothing else that can contract.  The cluster helpers
// launch a sweep as one thread-block cluster per grid and let a block reach
// its peers' shared memory (DSMEM).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 BIG = 1e10 and 0.5 * BIG (fmm.py::BIG)
constexpr float BIG = 0x1.2a05f2p+33f;
constexpr float HALF_BIG = 0x1.2a05f2p+32f;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// float32 a * b + c rounded once: the FMA that XLA's CPU backend contracts
// and the plain version reproduces through float64 (fmm.py::_fma).  The
// two agree unless the float64 sum is inexact and lands exactly on a
// float32 rounding midpoint, which the neighbouring-magnitude operands of
// these updates do not produce (the kernels check out bit-equal to the
// plain versions).  A hardware FMA, where float64 costs 5 instructions.
__device__ __forceinline__ float fma1(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// The root is taken only where it is used: for |a - b| < 1 the radicand
// 2 - (a - b)^2 lies in (1, 2], where sqrtf stays on its short path; a
// radicand of 0 (|a - b| >= sqrt 2, every cell beside the front) would
// branch to its slow path for a value that is thrown away.
__device__ __forceinline__ float godunov(float a, float b) {
  float diff = a - b;
  float direct = fminf(a, b) + 1.0f;
  bool one_axis = fabsf(diff) >= 1.0f;
  float disc = sqrtf(one_axis ? 1.0f : fma1(-diff, diff, 2.0f));
  float both = 0.5f * ((a + b) + disc);
  return one_axis ? direct : both;
}

// ---- cluster sweeps ------------------------------------------------------
//
// A cluster of C blocks solves one grid; block `rank` owns the segment
// [rank * seg, rank * seg + width) of the n columns (B2) or rows of a row
// block (B4) (the last block's width may be smaller).  Every block lays out
// its shared memory alike, so a peer's copy of a buffer sits at the same
// offset in the peer's shared memory.

constexpr int SWEEP_NT = 512;    // threads per block of both sweeps

struct Cluster {
  int rank, size, grid, c0, width;
};

__device__ __forceinline__ Cluster cluster_init(int n, int seg) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  Cluster cl;
  cl.rank = (int)cluster.block_rank();
  cl.size = (int)cluster.num_blocks();
  cl.grid = blockIdx.x / cl.size;
  cl.c0 = cl.rank * seg;
  cl.width = imax(0, imin(seg, n - cl.c0));
  return cl;
}

// Block q's copy of the shared-memory buffer `mine` (one `mapa`).
template <typename T>
__device__ __forceinline__ T* peer(T* mine, int q) {
  return cooperative_groups::this_cluster().map_shared_rank(mine, q);
}

// Every thread of every block of the cluster arrives; shared-memory writes
// before it (local and remote) are seen by every reader after it.  A
// cluster of one block needs only the block barrier, which costs a small
// part of a cluster barrier's ~0.65 us (scripts/torch_sweep_breakdown.py).
__device__ __forceinline__ void cluster_barrier(int size) {
  if (size == 1)
    __syncthreads();
  else
    cooperative_groups::this_cluster().sync();
}

// A sweep block holds its SM alone: it reserves more than half an SM's
// 228 KB of shared memory, whatever its layout uses, so the card never puts
// two blocks (of one cluster or of two) on one SM, where they would share
// its issue slots and lengthen every link of the chain.  The launch plan
// then sees the clusters the card holds one block an SM.
constexpr size_t SOLE_BLOCK_SMEM = 116 * 1024;

inline size_t reserved_smem(size_t smem) {
  return smem > SOLE_BLOCK_SMEM ? smem : SOLE_BLOCK_SMEM;
}

// Sets the attributes a cluster launch of `kernel` needs: the dynamic
// shared memory it reserves for a layout of `smem` bytes and clusters of up
// to 16 blocks.
template <typename K>
cudaError_t cluster_attributes(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)reserved_smem(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

inline cudaLaunchConfig_t cluster_config(int grids, int cluster, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grids * cluster);
  cfg.blockDim = dim3(SWEEP_NT);
  cfg.dynamicSmemBytes = reserved_smem(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `cluster` blocks of an `smem`-byte layout the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
template <typename K>
int max_active_clusters(K kernel, int cluster, size_t smem, int* out) {
  cudaError_t err = cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, cluster, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace
