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
// What bounds it on the card: the bytes, x read once and the output written
// once (2 * 294,912 bytes at the repro's 8 x 8 x 1152, 0.176 us at the
// H100's 3.35 TB/s); at that size a launch's own latency is most of its
// time, so the design is about latency: as many SMs as the shape allows,
// each moving its bytes in one request each way.
//
// Design: one block a (b, g) row (64 blocks at the repro's shape), the row
// staged in shared memory, the on-chip scratch of the repro:
//   - thread 0 stages the row's 16-byte-aligned interior with one 1-D bulk
//     copy (TMA, cp.async.bulk ... mbarrier::complete_tx::bytes) completing
//     on an mbarrier, to the start of the block's shared memory;
//   - meanwhile the threads copy the row's unaligned head and tail (at most
//     3 floats each, present when R % 4 != 0 or x starts mid-row) from x to
//     the output themselves, rewriting the ones in the slice;
//   - after the mbarrier, the threads that own the slice's columns in the
//     interior rewrite them in shared memory (one thread for the width-1
//     write), fence the async proxy (fence.proxy.async.shared::cta), and
//     thread 0 copies the interior out with one bulk copy
//     (cp.async.bulk.global.shared::cta.bulk_group) and waits for its bulk
//     group before the block exits.
// The multiply and add are rounded apart (__fmul_rn, __fadd_rn), as the
// Pallas kernel's two ops are; times 0.5 is exact for normal floats.  A row
// of at most MAX_ROW floats fits a block's shared memory.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3).
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_ROW = 57344;     // floats: 224 KiB of a block's 227 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float rewrite(float v) {
  return __fadd_rn(__fmul_rn(v, 0.5f), 1.0f);
}

__global__ void __launch_bounds__(THREADS)
width1_slice_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int r_dim, int c, int ok) {
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) float row[];   // the interior, <= MAX_ROW
  const int tid = threadIdx.x;
  const size_t start = (size_t)blockIdx.x * r_dim;
  const float* src = x + start;
  float* dst = out + start;
  // the row's floats before its first 16-byte boundary, then the aligned
  // interior (n_int floats), then the tail
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - mis) & 3, r_dim);
  const int n_int = (r_dim - head) & ~3;
  const int tail0 = head + n_int;
  const int c_end = ok ? r_dim : c + 1;
  float* interior = row;
  const uint32_t bytes = (uint32_t)n_int * 4u;

  if (tid == 0 && bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(&bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(interior)),
        "l"(src + head), "r"(bytes), "r"(smem_u32(&bar)) : "memory");
  }
  // the unaligned head and tail, by the threads, device memory to device
  // memory
  const int edges = head + (r_dim - tail0);
  for (int i = tid; i < edges; i += THREADS) {
    const int col = i < head ? i : tail0 + (i - head);
    const float v = src[col];
    dst[col] = (col >= c && col < c_end) ? rewrite(v) : v;
  }
  if (!bytes) return;
  // every thread waits for the row: the mbarrier's phase 0 completes when
  // the bulk copy's bytes have landed
  __syncthreads();   // the mbarrier is initialised before anyone waits
  {
    const uint32_t addr = smem_u32(&bar);
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(addr) : "memory");
    } while (!done);
  }
  // the slice's columns that lie in the interior, one thread a column
  const int lo = max(c, head), hi = min(c_end, tail0);
  for (int col = lo + tid; col < hi; col += THREADS)
    interior[col - head] = rewrite(interior[col - head]);
  // the rewritten words, written by the generic proxy, made visible to the
  // bulk copy's async proxy, then one copy out
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst + head), "r"(smem_u32(interior)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace

// out <- x with out[:, :, c] (ok = 0) or out[:, :, c:] (ok = 1) replaced by
// x * 0.5 + 1, for x and out [b, g, r] float32, both starting on 16-byte
// boundaries.  Returns 0, or the CUDA error of the launch
// (cudaErrorInvalidValue for what the kernel does not take: a row over
// MAX_ROW floats, c outside [0, r), or a misaligned pointer).
extern "C" int width1_slice_launch(const float* x, float* out, int b, int g,
                                   int r, int c, int ok, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (b < 1 || g < 1 || r < 1 || r > MAX_ROW || c < 0 || c >= r)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
      15)
    return (int)cudaErrorInvalidValue;
  const int smem = r * (int)sizeof(float);
  static bool attribute_set = false;
  if (!attribute_set) {
    const int err = (int)cudaFuncSetAttribute(
        width1_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_ROW * (int)sizeof(float));
    if (err != 0) return err;
    attribute_set = true;
  }
  width1_slice_kernel<<<b * g, THREADS, (size_t)smem, s>>>(x, out, r, c, ok);
  return (int)cudaGetLastError();
}
