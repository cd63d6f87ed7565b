// The card's launch floor: kernels that do nothing, launched through the same ctypes
// path as the port's kernels, so that a kernel's time can be read against the time of
// a launch that computes nothing.  Replaces no TPU kernel; chip_smoke.py times it.
//
//   launch_floor(stream)                    one block of 32 threads
//   launch_floor_grid(blocks, C, threads, stream)  a plain grid (blocks, C): kernel A's forward
//   launch_floor_cluster(C, threads, stream) kernel B's and kernel A's backward's geometry: a
//                                           cluster of 8 blocks per chain, grid (8, C), and one
//                                           cluster.sync()
// Each returns the CUDA error of its launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void empty_cluster_kernel() { cooperative_groups::this_cluster().sync(); }

}  // namespace

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int launch_floor_grid(int blocks, int C, int threads, void* stream) {
  empty_kernel<<<dim3(blocks, C, 1), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int launch_floor_cluster(int C, int threads, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8, C, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, empty_cluster_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
