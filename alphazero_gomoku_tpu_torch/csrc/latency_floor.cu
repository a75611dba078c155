// Two probes of the least time a latency-bound kernel can take on the card,
// for the tree kernels' floor (tools/latency_floor.py):
//   empty_kernel  does nothing: what a launch costs by itself;
//   chase_kernel  one thread follows a chain of indices, each load waiting
//                 for the one before: one dependent L2 load a step.
// Neither replaces a TPU kernel; no path of the port launches them.
//
// Built by ops/_build.py as a shared library with a plain C interface.
// Each entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

// next[i] is the index to load after i; ld.global.cg caches in L2 only, so
// every step is an L1 miss that the chain's warm-up left in L2
__global__ void chase_kernel(const unsigned* __restrict__ next, int steps,
                             unsigned* __restrict__ out) {
  unsigned i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;  // the chain's end, so that no load can be dropped
}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int chase_launch(const unsigned* next, int steps, unsigned* out,
                            void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}
