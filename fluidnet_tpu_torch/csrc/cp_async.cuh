// Asynchronous 4-byte copies from global to shared memory (cp.async), for
// the z-marching kernels that stage input planes ahead of their compute
// (prologue.cu, mac_sweep.cu).
#pragma once

#include <cuda_runtime.h>

// One 4-byte asynchronous copy from global to shared memory; zeros when
// !valid (src-size 0: nothing is read from src).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
