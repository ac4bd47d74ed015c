// kernel<<<grid, block, smem, stream>>>(args...) in thread-block clusters of
// `cluster` blocks along x, for the kernels of fused_als.cu that share data
// through distributed shared memory (1: no cluster).

#pragma once

#include <cuda_runtime.h>

namespace launch {

template <typename... Kargs, typename... Args>
inline cudaError_t clustered(void (*kernel)(Kargs...), dim3 grid, dim3 block,
                             size_t smem, cudaStream_t stream, int cluster,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Kargs>(args)...);
}

}  // namespace launch
