// Code shared by the port's kernel sources: the error-string export of each
// library (every source includes this header).

#pragma once

#include <cuda_runtime.h>

// Each source including this header is its own shared library (loaded
// RTLD_LOCAL by ops/_build.py), so each exports this symbol once.
extern "C" const char* helib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
