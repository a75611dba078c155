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
// Instructions: the towers' own wgmma forms, issued through the helpers of
// csrc/conv_tile.cuh (the towers' shared core): int8 as one m64n128k32
// s32.s8.s8 (wgmma_s8_n128, what the int8 tower issues) per 32 bytes of K,
// bf16 as two m64n64k16 f32.bf16.bf16 (wgmma_bf16_n64, the bf16 tower's)
// for the 128 columns.  A and B both come from shared memory through
// descriptors without swizzle over chunk planes (16 bytes of K of every
// row, rows 16 bytes apart), as the towers read them: a row shift r is a
// move of A's start address by r * 16 bytes, as a tap is in conv_tile.cuh,
// and nothing is re-staged or loaded into registers.  Every wgmma is an asm
// volatile statement, so nvcc can neither drop the earlier steps, whose
// sums are overwritten, nor merge them: the counterpart of the Pallas
// kernel's zero-valued dependence of each step's weight on the last
// accumulator.
//
// Layout: the wrapper (tools/matmul_rate.py, rate_planes) lays x out as
// chunk planes [k * E / 16][rows][16 bytes] (E the element's bytes; rows =
// the tiles' 128 rows each, plus the reps - 1 rows a tile's shifts read
// past its end, rounded up to 8; zero past x's rows), and w as
// [N / 128][k * E / 16][128][16 bytes] (per slice of 128 columns, per chunk
// of K, the columns' 16 bytes).
//
// Schedule: the work is tiles of 128 output rows (64 a consumer warpgroup)
// by 128 columns, each `steps` times; its units, (tile, step) in tile-major
// order, are split evenly over persistent blocks, one an SM, so that every
// SM has work at M 2040 too (16 tiles on 132 SMs) and the last wave is not
// ragged at M 57600 (450 tiles).  A block runs its units in order, and the
// unit that is its tile's last step stores the tile; rows past M are masked.
// Each step zeroes the accumulators, issues its reps * k / (32 bytes)
// instructions (twice that in bf16), and waits for them.
//   - Resident (a tile's A rows and B fit in shared memory: k = 128): both
//     are staged once per tile by bulk copies (cp.async.bulk) completing on
//     an mbarrier, and each step issues all its instructions back to back,
//     then one commit and one wait.
//   - Streamed (k = 1152, where w alone is 147 KB int8, 295 KB bf16): a
//     ring of stages of STAGE_CHUNKS chunk planes of A and B, fed by a
//     producer warp's bulk copies (a full and an empty mbarrier a stage);
//     the consumers wait for each stage, keep one stage's instructions in
//     flight (wgmma.wait_group 1) and release the stage before it.  This is
//     what an im2col tower on wgmma would pay with asynchronous staging.
//
// What bounds it on the card: the operations, 2 * M * k * N * reps per
// step, over the dense tensor-core rate of the type (H100 SXM data sheet:
// int8 1979 TOP/s, bf16 989 TFLOP/s); a resident step reads nothing from
// device memory.  With A and B both read from shared memory an int8
// instruction needs 2 KB of A and 4 KB of B, 96 of shared memory's 128
// bytes a clock at the dense rate; a bf16 m64n64k16 2 KB of each, all 128
// (conv_tile.cuh's note), so bf16 has no headroom there.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3).
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

namespace ct = conv_tile;

constexpr int TILE_M = 128;      // output rows of a tile: 64 a warpgroup
constexpr int TILE_N = 128;      // output columns of a tile
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int PRODUCER = 32;     // the streamed kernel's producer warp
constexpr int STAGE_CHUNKS = 8;  // chunk planes of K a ring stage (at most)
constexpr int MAX_STAGES = 6;
constexpr int BARS = 128;        // the header: mbarriers

struct Args {
  int m, n;
  int kc;          // 16-byte chunks of K
  int reps, steps;
  int rows;        // rows of x's chunk planes
  int a_rows;      // rows a tile stages: 128 + (reps - 1) rounded up to 8
  int m_tiles;     // tiles along M; tile t is rows (t % m_tiles) * 128,
                   // columns (t / m_tiles) * 128
  long long units; // tiles * steps
  int chunks;      // streamed: chunk planes a stage
  int stages;      // streamed: stages of the ring
};

// Accumulators of a warpgroup's 64 x 128 tile: H instructions of 128 / H
// columns each (int8: one n128; bf16: two n64), 64 / H registers each.
template <typename Acc, int H>
struct Tile {
  Acc d[H][64 / H];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int i = 0; i < 64 / H; ++i) d[h][i] = Acc(0);
      ct::fence_acc(d[h]);
    }
  }

  // 32 bytes of K: a from A's descriptor, the columns from B's, each half
  // of the columns (128 / H) * 16 bytes on
  __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      ct::wgmma(d[h], a, b + (uint64_t)(h * (TILE_N / H)));
  }

  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int h = 0; h < H; ++h) ct::fence_acc(d[h]);
  }

  // Thread lt of the warpgroup holds rows 16 * (lt / 32) + (lt % 32) / 4
  // (+ 8) of its 64, and column pairs 8j + 2 (lt % 4) of each instruction's.
  __device__ __forceinline__ void store(Acc* out, int row0, int col0, int lt,
                                        int m, int n) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * (lt >> 5) + ((lt & 31) >> 2) + 8 * r;
      if (row >= m) continue;
      Acc* o = out + (size_t)row * n + col0 + 2 * (lt & 3);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < TILE_N / H / 8; ++j) {
          o[h * (TILE_N / H) + 8 * j] = d[h][4 * j + 2 * r];
          o[h * (TILE_N / H) + 8 * j + 1] = d[h][4 * j + 2 * r + 1];
        }
    }
  }
};

// A descriptor of a tile's A (chunk planes of `a_rows` rows, warpgroup wg's
// 64 rows) and of B (chunk planes of 128 columns).
__device__ __forceinline__ uint64_t a_desc(const uint8_t* a, int a_rows,
                                           int wg) {
  return ct::desc(ct::smem_u32(a) + wg * 64 * 16, a_rows * 16, 128);
}
__device__ __forceinline__ uint64_t b_desc(const uint8_t* b) {
  return ct::desc(ct::smem_u32(b), TILE_N * 16, 128);
}

// One stage's instructions: every row shift and 32-byte step of `chunks`
// chunk planes.  Offsets are in 16-byte units of the descriptors' start.
template <typename Acc, int H>
__device__ __forceinline__ void issue(Tile<Acc, H>& acc, uint64_t a,
                                      uint64_t b, int chunks, int a_rows,
                                      int reps) {
  for (int r = 0; r < reps; ++r)
#pragma unroll 4
    for (int c = 0; c < chunks; c += 2)
      acc.mma(a + (uint64_t)(c * a_rows + r), b + (uint64_t)(c * TILE_N));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   ct::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The block's units [u0, u1): an even share of all of them.
__device__ __forceinline__ void block_units(const Args& g, long long& u0,
                                            long long& u1) {
  u0 = g.units * blockIdx.x / gridDim.x;
  u1 = g.units * (blockIdx.x + 1) / gridDim.x;
}

template <typename Acc, int H>
__global__ void __launch_bounds__(CONSUMERS, 1)
rate_resident(const uint8_t* __restrict__ xp, const uint8_t* __restrict__ wp,
              Acc* __restrict__ out, const Args g) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* const sa = smem + BARS;                     // [kc][a_rows][16]
  uint8_t* const sb = sa + (size_t)g.kc * g.a_rows * 16;  // [kc][128][16]
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
    ct::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  long long u0, u1;
  block_units(g, u0, u1);
  const uint64_t a = a_desc(sa, g.a_rows, wg);
  const uint64_t b = b_desc(sb);
  Tile<Acc, H> acc;
  uint32_t phase = 0;
  for (long long u = u0; u < u1;) {
    const int tile = (int)(u / g.steps);
    const int first = (int)(u - (long long)tile * g.steps);
    const int last = (int)min((long long)g.steps, first + (u1 - u));
    const int mt = tile % g.m_tiles;
    const int ns = tile / g.m_tiles;
    if (u != u0) __syncthreads();  // both warpgroups done with the last tile
    if (tid == 0) {
      const uint32_t a_bytes = (uint32_t)g.a_rows * 16;
      const uint32_t b_bytes = (uint32_t)g.kc * TILE_N * 16;
      ct::mbar_expect_tx(bar, a_bytes * g.kc + b_bytes);
      for (int c = 0; c < g.kc; ++c)
        ct::bulk_copy(sa + (size_t)c * a_bytes,
                      xp + ((size_t)c * g.rows + (size_t)mt * TILE_M) * 16,
                      a_bytes, bar);
      ct::bulk_copy(sb, wp + (size_t)ns * b_bytes, b_bytes, bar);
    }
    ct::mbar_wait(bar, phase);
    __syncwarp();  // the warp converged again for the wgmma's .aligned
    phase ^= 1u;
    for (int step = first; step < last; ++step) {
      acc.zero();
      ct::wgmma_fence();
      issue(acc, a, b, g.kc, g.a_rows, g.reps);
      ct::wgmma_commit();
      ct::wgmma_wait_all();
      acc.fence();
    }
    if (last == g.steps)
      acc.store(out, mt * TILE_M + wg * 64, ns * TILE_N, tid & 127, g.m, g.n);
    u += last - first;
  }
}

template <typename Acc, int H>
__global__ void __launch_bounds__(CONSUMERS + PRODUCER, 1)
rate_streamed(const uint8_t* __restrict__ xp, const uint8_t* __restrict__ wp,
              Acc* __restrict__ out, const Args g) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  const uint32_t a_bytes = (uint32_t)g.chunks * g.a_rows * 16;
  const uint32_t b_bytes = (uint32_t)g.chunks * TILE_N * 16;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      ct::mbar_init(&full[s], 1);
      ct::mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  long long u0, u1;
  block_units(g, u0, u1);
  const int per_step = g.kc / g.chunks;

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues the copies
    if (tid != CONSUMERS) return;
    int i = 0;
    for (long long u = u0; u < u1; ++u) {
      const int tile = (int)(u / g.steps);
      const int mt = tile % g.m_tiles;
      const int ns = tile / g.m_tiles;
      for (int ch = 0; ch < per_step; ++ch, ++i) {
        const int s = i % g.stages;
        ct::mbar_wait(&empty[s], ((uint32_t)(i / g.stages) & 1u) ^ 1u);
        uint8_t* const sa = smem + BARS + (size_t)s * (a_bytes + b_bytes);
        ct::mbar_expect_tx(&full[s], a_bytes + b_bytes);
        for (int c = 0; c < g.chunks; ++c)
          ct::bulk_copy(
              sa + (size_t)c * g.a_rows * 16,
              xp + ((size_t)(ch * g.chunks + c) * g.rows +
                    (size_t)mt * TILE_M) * 16,
              (uint32_t)g.a_rows * 16, &full[s]);
        ct::bulk_copy(sa + a_bytes,
                      wp + ((size_t)ns * g.kc + (size_t)ch * g.chunks) *
                               TILE_N * 16,
                      b_bytes, &full[s]);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  Tile<Acc, H> acc;
  int i = 0;
  for (long long u = u0; u < u1; ++u) {
    const int tile = (int)(u / g.steps);
    acc.zero();
    for (int ch = 0; ch < per_step; ++ch, ++i) {
      const int s = i % g.stages;
      ct::mbar_wait(&full[s], (uint32_t)(i / g.stages) & 1u);
      __syncwarp();
      const uint8_t* sa = smem + BARS + (size_t)s * (a_bytes + b_bytes);
      ct::wgmma_fence();
      issue(acc, a_desc(sa, g.a_rows, wg), b_desc(sa + a_bytes), g.chunks,
            g.a_rows, g.reps);
      ct::wgmma_commit();
      if (ch > 0) {  // the stage before this one is read: release it
        wgmma_wait_1();
        mbar_arrive(&empty[(i - 1) % g.stages]);
      }
    }
    ct::wgmma_wait_all();
    acc.fence();
    mbar_arrive(&empty[(i - 1) % g.stages]);
    if (u - (long long)tile * g.steps == g.steps - 1)
      acc.store(out, (tile % g.m_tiles) * TILE_M + wg * 64,
                (tile / g.m_tiles) * TILE_N, tid & 127, g.m, g.n);
  }
}

// Lets Kernel's blocks take the most shared memory a block may have, once.
template <auto Kernel>
int allow_smem() {
  static int err = (int)cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ct::SMEM_LIMIT);
  return err;
}

template <typename Acc, int H>
int launch(const void* xp, const void* wp, void* out, Args g,
           cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = g.units < sms ? (int)g.units : sms;
  const auto* x = static_cast<const uint8_t*>(xp);
  const auto* w = static_cast<const uint8_t*>(wp);
  Acc* o = static_cast<Acc*>(out);
  const long long resident =
      BARS + (long long)g.kc * (g.a_rows + TILE_N) * 16;
  if (resident <= ct::SMEM_LIMIT) {
    const int err = allow_smem<rate_resident<Acc, H>>();
    if (err != 0) return err;
    rate_resident<Acc, H><<<grid, CONSUMERS, (int)resident, s>>>(x, w, o, g);
    return (int)cudaGetLastError();
  }
  g.chunks = g.kc % STAGE_CHUNKS == 0 ? STAGE_CHUNKS
             : g.kc % 4 == 0          ? 4
                                      : 2;
  const long long stage = (long long)g.chunks * (g.a_rows + TILE_N) * 16;
  const long long fit = (ct::SMEM_LIMIT - BARS) / stage;
  g.stages = fit < MAX_STAGES ? (int)fit : MAX_STAGES;
  if (g.stages < 2) return (int)cudaErrorInvalidValue;
  const int err = allow_smem<rate_streamed<Acc, H>>();
  if (err != 0) return err;
  rate_streamed<Acc, H><<<grid, CONSUMERS + PRODUCER,
                          BARS + (int)(g.stages * stage), s>>>(x, w, o, g);
  return (int)cudaGetLastError();
}

}  // namespace

// out [m, n] <- the last of `steps` sums sum_{r < reps} x[r : r + m] @ w,
// for x and w in the chunk planes of tools/matmul_rate.py rate_planes: xp
// [k * E / 16][rows][16 bytes] with rows = ceil(m / 128) * 128 + (reps - 1)
// rounded up to 8, wp [n / 128][k * E / 16][128][16 bytes].  dtype 0: int8
// -> int32; 1: bf16 -> float32.  k * E must be a multiple of 32 bytes, n of
// 128; m, reps and steps at least 1.  Returns 0, or the launch's CUDA error
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int matmul_rate_launch(int dtype, const void* xp, const void* wp,
                                  void* out, int m, int k, int n, int reps,
                                  int steps, int rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int elem = dtype == 0 ? 1 : 2;
  if ((dtype != 0 && dtype != 1) || m < 1 || reps < 1 || steps < 1 ||
      k < 1 || (k * elem) % 32 != 0 || n < TILE_N || n % TILE_N != 0)
    return (int)cudaErrorInvalidValue;
  Args g = {};
  g.m = m;
  g.n = n;
  g.kc = k * elem / 16;
  g.reps = reps;
  g.steps = steps;
  g.a_rows = TILE_M + (reps - 1 + 7) / 8 * 8;
  g.m_tiles = (m + TILE_M - 1) / TILE_M;
  g.rows = rows;
  g.units = (long long)g.m_tiles * (n / TILE_N) * steps;
  if (rows != (g.m_tiles - 1) * TILE_M + g.a_rows)
    return (int)cudaErrorInvalidValue;
  return dtype == 0 ? launch<int, 1>(xp, wp, out, g, s)
                    : launch<float, 2>(xp, wp, out, g, s);
}
