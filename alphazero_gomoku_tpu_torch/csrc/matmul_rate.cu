// The tensor-core rate probe for Hopper (sm_90a): matmul_rate.
//
// Replaces the Pallas kernel tools/mosaic_matmul_rate.py pallas_rate (body
// kern, pallas_call at :65): for x [M + reps, k] and w [k, N], and a step
// count given at run time, every step computes
//     out = sum_{r < reps} x[r : r + M] @ w
// from zero, and the last step's sum is stored; int8 x int8 -> int32 or
// bf16 x bf16 -> float32.  Many steps of the same work in one launch make a
// rate that the caller takes from the difference between two step counts.
//
// Instructions: int8 as mma.sync.m16n8k32.row.col.s32.s8.s8.s32, the one
// the int8 tower (csrc/int8_tower.cu) issues; bf16 as
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, what the bf16 tower's wmma
// 16x16x16 fragments (csrc/fused_net.cu) lower to.  Every mma is an asm
// volatile statement, so nvcc can neither drop the earlier steps, whose sums
// are overwritten, nor merge them: the counterpart of the Pallas kernel's
// zero-valued dependence of each step's weight on the last accumulator.
//
// Design: the layout of the int8 tower's GEMM.  A block of 8 warps (4 along
// M x 2 along N) owns a 128 x 128 output tile, each warp a 32 x 64 slice
// in 2 x 8 mma tiles with register accumulators; rows past M are masked.
// Both operands are staged in shared memory with rows of k bytes plus 16 of
// padding, so that the 32-bit fragment loads of a warp hit 32 distinct
// banks: the block's 128 + reps - 1 rows of x, and w transposed ([N][k]: the
// mma wants 4 (int8) or 2 (bf16) consecutive k of one column in a 32-bit
// register), which the caller hands over in that layout.  The two operands
// have the same byte layout in both types (a 32-byte slice of k per mma), so
// one kernel serves both.
// Per 32-byte slice of k a warp loads its B fragments once and reuses them
// for all reps row shifts of x.
//
// What bounds it on the card: the operations, 2 * M * k * N * reps per
// step, over the dense tensor-core rate of the type (H100 SXM data sheet:
// int8 1979 TOP/s, bf16 989 TFLOP/s); a step reads nothing from device
// memory.  Where both operands fit in shared memory (k = 128: 38 KB int8,
// 72 KB bf16 at reps 9) they are staged once before the first step, and the
// steps measure mma.sync fed from shared memory, the ceiling of the towers'
// instruction choice.  At k = 1152 they do not (w alone is 147 KB int8,
// 295 KB bf16): every step then walks k in chunks of 256 bytes, each staged
// from L2 between two block-wide barriers, and the shape measures mma.sync
// with synchronous staging, what an im2col tower built this way would pay.
// The grid is ceil(M / 128) x (N / 128) blocks: at M = 2040 that is 16
// blocks for 132 SMs, at M = 57600 (the towers' GEMM at batch 256) 450.
// wgmma, whose operands come from shared memory without register fragments,
// is the way to the full rate and is not used here.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3).
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int BN = 128;          // output columns per block
constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int PAD = 16;          // shared-memory row padding in bytes
constexpr int CHUNK = 256;       // bytes of k per staged chunk when streamed
constexpr int MMA_K_BYTES = 32;  // bytes of k per mma (32 int8, 16 bf16)
constexpr int SMEM_LIMIT = 232448;     // 227 KB, a block's most on sm_90
constexpr int RESIDENT_LIMIT = 113664;  // 111 KB: two blocks per SM

struct MmaS8 {
  using Acc = int;
  static constexpr int ELEM = 1;
  static __device__ __forceinline__ void mma(int* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct MmaBf16 {
  using Acc = float;
  static constexpr int ELEM = 2;
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + rows) of a row-major matrix of row_bytes-byte rows,
// bytes [c0, c0 + cb) of each, into shared memory rows of ld bytes; rows at
// or past n_rows are zero.  cb, c0, row_bytes and ld are multiples of 16.
__device__ __forceinline__ void stage(uint8_t* dst, int ld,
                                      const uint8_t* __restrict__ src,
                                      int row_bytes, int row0, int rows,
                                      int n_rows, int c0, int cb) {
  const int vecs = cb / 16;
  for (int i = threadIdx.x; i < rows * vecs; i += THREADS) {
    const int r = i / vecs;
    const int q = i % vecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_bytes +
                                          c0 + 16 * q);
    *reinterpret_cast<uint4*>(dst + r * ld + 16 * q) = v;
  }
}

// One block: output rows p0 .. p0 + 127, columns n0 .. n0 + 127.  x has
// m + reps rows of k_bytes bytes, wt n rows of k_bytes bytes; k is walked in
// chunks of `chunk` bytes (one chunk: staged once, before the first step).
template <typename Op>
__global__ void __launch_bounds__(THREADS, 2)
matmul_rate_kernel(const uint8_t* __restrict__ x,
                   const uint8_t* __restrict__ wt,
                   typename Op::Acc* __restrict__ out, int m, int n,
                   int k_bytes, int reps, int steps, int chunk) {
  using Acc = typename Op::Acc;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ld = chunk + PAD;
  const int a_rows = BM + reps - 1;
  uint8_t* sa = smem;
  uint8_t* sb = smem + a_rows * ld;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;        // the fragment's group (row / column)
  const int t = lane & 3;         // its thread in the group
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int n_chunks = (k_bytes + chunk - 1) / chunk;

  if (n_chunks == 1) {
    stage(sa, ld, x, k_bytes, p0, a_rows, m + reps, 0, k_bytes);
    stage(sb, ld, wt, k_bytes, n0, BN, n, 0, k_bytes);
    __syncthreads();
  }

  Acc acc[2][8][4];
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * chunk;
      const int cb = min(chunk, k_bytes - c0);
      if (n_chunks > 1) {
        __syncthreads();    // every warp is done with the last chunk
        stage(sa, ld, x, k_bytes, p0, a_rows, m + reps, c0, cb);
        stage(sb, ld, wt, k_bytes, n0, BN, n, c0, cb);
        __syncthreads();
      }
      for (int kk = 0; kk < cb; kk += MMA_K_BYTES) {
        uint32_t b[8][2];
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const uint8_t* base = sb + (wn * 64 + ni * 8 + g) * ld + kk + 4 * t;
          b[ni][0] = lds32(base);
          b[ni][1] = lds32(base + 16);
        }
        for (int r = 0; r < reps; ++r) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint8_t* base =
                sa + (wm * 32 + mi * 16 + g + r) * ld + kk + 4 * t;
            a[mi][0] = lds32(base);
            a[mi][1] = lds32(base + 8 * ld);
            a[mi][2] = lds32(base + 16);
            a[mi][3] = lds32(base + 8 * ld + 16);
          }
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              Op::mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
      }
    }
  }

  // accumulator element e of tile (mi, ni) is row g + 8 * (e >> 1), column
  // 2 * t + (e & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 32 + mi * 16 + g + 8 * half;
      if (p >= m) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + 2 * t;
        Acc* o = out + (size_t)p * n + col;
        o[0] = acc[mi][ni][2 * half];
        o[1] = acc[mi][ni][2 * half + 1];
      }
    }
  }
}

long long smem_bytes(int chunk, int reps) {
  return (long long)(BM + reps - 1 + BN) * (chunk + PAD);
}

template <typename Op>
int launch(const void* x, const void* wt, void* out, int m, int k, int n,
           int reps, int steps, cudaStream_t s) {
  const int k_bytes = k * Op::ELEM;
  int chunk = k_bytes;
  if (smem_bytes(chunk, reps) > RESIDENT_LIMIT) {
    chunk = CHUNK;
    while (chunk > MMA_K_BYTES && smem_bytes(chunk, reps) > SMEM_LIMIT)
      chunk /= 2;
  }
  if (smem_bytes(chunk, reps) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(chunk, reps);
  static bool attribute_set = false;
  if (!attribute_set) {
    const int err = (int)cudaFuncSetAttribute(
        matmul_rate_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err != 0) return err;
    attribute_set = true;
  }
  const dim3 grid((m + BM - 1) / BM, n / BN);
  matmul_rate_kernel<Op><<<grid, THREADS, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(wt),
      static_cast<typename Op::Acc*>(out), m, n, k_bytes, reps, steps, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// out [m, n] <- the last of `steps` sums sum_{r < reps} x[r : r + m] @ w,
// for x [m + reps, k] row-major and w given transposed, wt [n, k] row-major.
// dtype 0: int8 -> int32; 1: bf16 -> float32.  k must be a multiple of the
// mma depth (32 int8, 16 bf16) and n of 128; m, reps and steps at least 1.
// Returns 0, or the launch's CUDA error (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int matmul_rate_launch(int dtype, const void* x, const void* wt,
                                  void* out, int m, int k, int n, int reps,
                                  int steps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (m < 1 || reps < 1 || steps < 1 || n < BN || n % BN != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && k > 0 && k % 32 == 0)
    return launch<MmaS8>(x, wt, out, m, k, n, reps, steps, s);
  if (dtype == 1 && k > 0 && k % 16 == 0)
    return launch<MmaBf16>(x, wt, out, m, k, n, reps, steps, s);
  return (int)cudaErrorInvalidValue;
}
