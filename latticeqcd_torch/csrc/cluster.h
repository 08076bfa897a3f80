// Thread-block clusters (sm_90): a kernel's dynamic shared memory and the cluster's
// cooperative-groups handle, kept behind this header so that a kernel body can also be
// compiled for the host against a mock of it (tests/test_torch_staggered_w_fused.py).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// The block's dynamic shared memory (the launch's dynamicSmemBytes), 16-byte aligned.
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  return smem_bytes;
}
