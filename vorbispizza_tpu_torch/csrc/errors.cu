// Error text for the codes the launch entries return.
#include "common.cuh"

VP_API const char* vp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
