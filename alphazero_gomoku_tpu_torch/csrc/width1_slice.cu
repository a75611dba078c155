// The width-1 slice write through an on-chip scratch for Hopper (sm_90a):
// width1_slice_write.
//
// Replaces the Pallas kernel repro/mosaic_width1_slice_hang.py kernel
// (pallas_call at :50), the repro of a Mosaic compiler hang: x [B, G, R]
// float32 is copied into a 3-D scratch, the scratch's column C of the minor
// dimension (variant "hang", ok = 0) or its columns C .. R - 1 (variant
// "ok", ok = 1) are rewritten as v * 0.5 + 1, and the scratch is copied
// out.  The Mosaic compiler never finished the width-1 variant; nvcc builds
// and runs both.
//
// Design: the whole [B, G, R] scratch (295 KB at the repro's 8 x 8 x 1152)
// is more than a block's shared memory, so each block holds one b's [G, R]
// slab (36.9 KB there) in shared memory, indexed [g][r], with blockIdx.x
// giving b: it copies x[b] into the slab, rewrites the slice in shared
// memory (one thread per element of the slice: G threads for the width-1
// write, each writing one word of a different row), and copies the slab
// out.  The multiply and add are rounded apart (__fmul_rn, __fadd_rn), as
// the Pallas kernel's two ops are; times 0.5 is exact for normal floats.
//
// What bounds it on the card: the bytes, x read once and the output written
// once (2 * 294,912 bytes at the repro's shape, 0.176 us at the H100's
// 3.35 TB/s); at that size a launch's own latency is the whole of its time
// (3.0-3.1 us a launch by CUDA-graph replay on an H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 20a).  8 blocks for 132 SMs: the shape, not the
// kernel, leaves the card idle.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3).
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;   // 227 KB, a block's most on sm_90

__global__ void __launch_bounds__(THREADS)
width1_slice_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int g_dim, int r_dim, int c, int ok) {
  extern __shared__ float slab[];   // [g_dim][r_dim]
  const int size = g_dim * r_dim;
  const size_t base = (size_t)blockIdx.x * size;
  for (int i = threadIdx.x; i < size; i += THREADS) slab[i] = x[base + i];
  __syncthreads();
  const int width = ok ? r_dim - c : 1;
  for (int i = threadIdx.x; i < g_dim * width; i += THREADS) {
    const int g = i / width;
    float* v = slab + g * r_dim + c + i % width;
    *v = __fadd_rn(__fmul_rn(*v, 0.5f), 1.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += THREADS) out[base + i] = slab[i];
}

}  // namespace

// out <- x with out[:, :, c] (ok = 0) or out[:, :, c:] (ok = 1) replaced by
// x * 0.5 + 1, for x and out [b, g, r] float32.  Returns 0, or the CUDA
// error of the launch (cudaErrorInvalidValue for a shape the kernel does not
// take: a [g, r] slab over 227 KB, or c outside [0, r)).
extern "C" int width1_slice_launch(const float* x, float* out, int b, int g,
                                   int r, int c, int ok, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (b < 1 || g < 1 || r < 1 || c < 0 || c >= r)
    return (int)cudaErrorInvalidValue;
  const long long smem = (long long)g * r * (long long)sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool attribute_set = false;
  if (!attribute_set) {
    const int err = (int)cudaFuncSetAttribute(
        width1_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err != 0) return err;
    attribute_set = true;
  }
  width1_slice_kernel<<<b, THREADS, (size_t)smem, s>>>(x, out, g, r, c, ok);
  return (int)cudaGetLastError();
}
