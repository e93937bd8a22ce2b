// Launch of a kernel whose grid.z splits one output tile's reduction:
// the splits of a tile form one thread-block cluster (1, 1, splits), so
// they can add their partial sums over distributed shared memory.  Used
// by conv_mma.cuh, cfmm_matmul.cu and block_sparse.cu.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Launch KERNEL on ``grid`` (grid.z == splits) with ``threads`` threads and
// ``smem`` bytes of dynamic shared memory on ``stream``: as one cluster of
// the z splits of each tile where splits > 1, else as a plain launch.
// Clusters of more than 8 blocks are non-portable: allowed once per device
// and kernel (the attribute is the device's), at its first launch, before
// any CUDA-graph capture.  Returns the launch's error code.
template <auto KERNEL, typename... Ts>
int launch_split_z(dim3 grid, int threads, int smem, cudaStream_t stream,
                   int splits, Ts... args) {
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !configured[dev]) {
    e = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;     // a tile's splits
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1;             // unsplit: a plain launch
  e = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace repro
