// Shared by every kernel library of the port: each .cu is built into its
// own shared library and exports this to turn a launcher's return code
// (cudaGetLastError()) into a message.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* stmask_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
