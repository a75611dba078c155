// The shared core of the two tower kernels for Hopper (sm_90a): one 3x3
// SAME convolution of a batch of square boards as an implicit GEMM on
// padded-board tiles, with wgmma and asynchronous copies.  Included by
// csrc/int8_tower.cu (int8 x int8 -> int32, int8_tower) and
// csrc/fused_net.cu (bf16 x bf16 -> float32, fused_tower); each supplies
// an Op: the element and accumulator types, the stem's conversion of an
// observation value, and the epilogue's per-channel parameters, value and
// packing.  ops/conv_tile.py mirrors the geometry and holds a plain
// version of the tiled conv.
//
// What it replaces: the conv of the Pallas kernels
// alphazero_gomoku_tpu/ops/int8_tower.py _tower_kernel (:129-160) and
// alphazero_gomoku_tpu/ops/fused_net.py _fused_kernel (:263-300).  Both lay
// a board out padded, with zero borders, p = size + 2 values a row, and
// compute a 3x3 conv as nine contiguous row slices of one staged buffer:
// output row q = y * p + x reads tap (dy, dx) at padded row q + dy * p + dx.
// Rows with x >= size are garbage and masked.
//
// Layout.  A conv's input activation lives in device memory as padded
// boards, one after another, R = p * p rows each, pixel (y, x) of board b
// at row b * R + (y + 1) * p + (x + 1).  It is stored in chunk planes:
// [C * sizeof(T) / 16][rows_total][16 bytes], each plane holding 16 bytes
// of channels of every row.  The wrapper zeroes the buffers once, at
// allocation, and keeps them; an epilogue writes only the interior pixels,
// so the borders stay zero.  The float32 skip track and the tower's output
// are NHWC, unpadded.
//
// A tile is MT = 64 output rows of one board's band (rows p + 1 ..
// p + size * p of the board, garbage columns included: four tiles a board
// at 15x15, 225 of their 256 rows pixels); its input is the MT + 2p + 2
// rows from board row s * MT on, and all nine taps read that one buffer, at
// row offsets dy * p + dx.  A warpgroup stages it with one bulk copy
// (cp.async.bulk, TMA's non-tensor form) per chunk plane, completing on an
// mbarrier: each activation row is staged once per conv and tile (the halo
// rows of the next tile again), not once per tap, and no thread spends
// registers on the copy.
//
// The weights of a conv stay resident in shared memory for the whole
// launch: all nine taps of the block's NS output channels, one bulk copy a
// tap from the layout ops/conv_tile.py tile_weights makes once per bundle
// ([slice][tap][chunk][NS][16 bytes]).  int8 at C = 128 takes 147 KB; bf16
// at C = 128 would take 295 KB, more than a block's 227 KB, so a bf16 block
// owns NS = 64 output channels (147 KB) and the two slices of a tile run on
// two blocks.
//
// Schedule: persistent blocks, one an SM, each of two consumer warpgroups
// with its own tiles (the block's tiles alternate between them), its own
// board buffers (two where they fit beside the weights: int8; one: bf16),
// and accumulators for its 64 rows and NS columns.  The warpgroups take
// turns on the tensor cores (two named barriers, the order of CUTLASS's
// ping-pong kernels): while one warpgroup's MMAs run, the other writes its
// previous tile from its accumulators, and its next tile's copy is in
// flight, issued as soon as its MMAs are done.  Before it waits for its
// turn a warpgroup loads its tile's skip values into registers, so that
// their latency runs under the MMAs.  The launch is a programmatic
// dependent launch: a block's set-up (barriers, parameters, the weights'
// copy) may start before the previous conv has ended, and only the reads
// of that conv's output wait for it (griddepcontrol).  At 15x15 and batch
// 256 that is 1024 tiles on 132 SMs (7.76 a block, 3.9 a warpgroup) in
// int8, and 1024 tiles on each of 66 block pairs (15.5 a block) in bf16.
//
// MMA: wgmma.mma_async m64nNk32 (s8) or m64nNk16 (bf16), 32 bytes of K an
// instruction, A and B both from shared memory through descriptors without
// swizzle.  Why A from shared memory: a tap's rows start at any offset
// dy * p + dx, and a wgmma descriptor needs only a 16-byte aligned start
// when its 8-row x 16-byte core matrices are contiguous.  In chunk planes
// they are, at every row offset (the core matrix at row r is the 128 bytes
// from r * 16 in its plane; the next 8 rows lie 128 bytes on, SBO; the next
// 16 bytes of K one plane on, LBO), so a tap is a change of the
// descriptor's start address and nothing is re-staged or shuffled through
// registers.  The plane stride is a constant (A_ROWS rows), so that every
// offset but dy * p is a constant of the unrolled MMA loop.  B uses the
// same layout, [tap][chunk][NS rows][16 bytes].  The 9 * K / 32
// instructions of a tile issue back to back, then one commit and one wait.
//
// Epilogue: straight from the accumulator registers, branch-free with
// predicated stores (see epilogue()); the plane rows written 16 bytes at a
// time.
//
// What bounds a conv: the operations, 2 * B * size^2 * 9 * C * C, over the
// tensor cores' dense rate (the computed rows are 256 per 225 pixels at
// 15x15); but with A and B both read from shared memory an instruction
// needs 2 KB of A and NS * 32 bytes of B, 96 of shared memory's 128 bytes a
// clock at the tensor cores' rate for int8 at N = 128 and all 128 for bf16
// at N = 64, and each
// conv's epilogue reads and writes the float32 skip track (59 MB at batch
// 256) and starts over the weights of a new conv.
//
// Limits (the wrappers check them first): square boards of side <= 21, so
// that a tile's MT + 2p + 2 rows fit a buffer plane of A_ROWS = MT + 48.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_tile {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;        // two consumer warpgroups
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int HEADER = 128;         // mbarriers: board buffers, weights
constexpr int MAX_PITCH = 23;       // boards up to 21 x 21
constexpr int BAR_MMA = 1;          // named barriers 1, 2: tensor-core turns
constexpr int BAR_WG = 3;           // named barriers 3, 4: one warpgroup

// Rows of a board buffer's chunk plane for tiles of MT rows.
__host__ __device__ constexpr int a_rows_max(int mt) {
  return mt + 2 * MAX_PITCH + 2;
}

enum Mode { STEM, CONV1, CONV2, CONV2_LAST };

struct Geometry {
  int size;        // board side
  int pitch;       // p = size + 2
  int board_rows;  // R = p * p
  int mt;          // output rows of a tile
  int segs;        // tiles a board: ceil(size * p / mt)
  int n_tiles;     // batch * segs
  int a_rows;      // a tile's staged rows: mt + 2p + 2
  int rows_total;  // rows of a chunk plane
};

inline Geometry geometry(int batch, int size, int mt) {
  Geometry g;
  g.size = size;
  g.pitch = size + 2;
  g.board_rows = g.pitch * g.pitch;
  g.mt = mt;
  g.segs = (size * g.pitch + mt - 1) / mt;
  g.n_tiles = batch * g.segs;
  g.a_rows = mt + 2 * g.pitch + 2;
  const int last = (batch - 1) * g.board_rows + (g.segs - 1) * mt + g.a_rows;
  const int need = last > batch * g.board_rows ? last : batch * g.board_rows;
  g.rows_total = (need + 7) / 8 * 8;
  return g;
}

// What a launch reads: the input planes (block convs) or the observation
// (the stem), and the weights.
struct ConvArgs {
  const uint8_t* act;     // input chunk planes (block convs)
  const uint8_t* w;       // [slice][tap][kc][NS][16 bytes] (tile_weights)
  const float* obs;       // the stem's observation, NHWC float32
  const float* inv_obs;   // int8 stem: requant reciprocal per plane
  int cin;                // the stem's planes
  int ks;                 // the stem's K in elements (zero past 9 * cin)
  int kc;                 // 16-byte chunks of K a tap (even)
  int n_slices;           // C_out / NS
  Geometry geo;
};

// What an epilogue writes.  Unused pointers are null.
struct EpiArgs {
  const float* scale;     // int8: dequant scale per output channel
  const float* bias;
  const float* inv_out;   // int8: requant reciprocal of the output
  float* skip;            // NHWC float32 skip track / tower output
  uint8_t* out;           // the next conv's input chunk planes
  int c;                  // the tower's channels
  int rows_total;
};

// Shared memory a channel of the epilogue's parameters (Op::load_params).
__host__ __device__ constexpr int params_bytes(int ns) { return ns * 24; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- barriers and copies ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Writes by the generic proxy (st.shared, cp.async) made visible to the
// async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers: `sync` waits for `n` threads of this and other warps,
// `arrive` counts this warp's threads without waiting.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- wgmma ----
// A shared-memory matrix descriptor without swizzle: start address, leading
// byte offset (the next 16 bytes of K), stride byte offset (the next 8
// rows), each in 16-byte units.  Adding n to it moves the start n * 16
// bytes on.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties the accumulators to the wgmma pipeline's fences, so that the
// compiler neither reads nor writes them across one.
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
template <typename Acc, int N>
__device__ __forceinline__ void fence_acc(Acc (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

// One m64nNk(32 bytes) instruction, D += A * B, picked by the accumulator
// array's type and length: s8 N = 32, 64, 128; bf16 N = 64.
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[16], uint64_t da, uint64_t db) {
  wgmma_s8_n32(d, da, db);
}
__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da, uint64_t db) {
  wgmma_s8_n64(d, da, db);
}
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db) {
  wgmma_s8_n128(d, da, db);
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  wgmma_bf16_n64(d, da, db);
}

// Stages tile t's input: a_rows rows of every chunk plane from board row
// s * mt on, one bulk copy a plane into planes of A_ROWS rows, on bar.
template <int A_ROWS>
__device__ __forceinline__ void load_tile(const ConvArgs& a, int t,
                                          uint8_t* dst, uint64_t* bar) {
  const Geometry& g = a.geo;
  const int b = t / g.segs;
  const size_t base =
      (size_t)b * g.board_rows + (size_t)(t - b * g.segs) * g.mt;
  const uint32_t bytes = (uint32_t)g.a_rows * 16;
  mbar_expect_tx(bar, bytes * a.kc);
  for (int kc = 0; kc < a.kc; ++kc)
    bulk_copy(dst + (size_t)kc * A_ROWS * 16,
              a.act + ((size_t)kc * g.rows_total + base) * 16, bytes, bar);
}

// The stem's A tile, gathered by one warpgroup (thread lt, rows lt,
// lt + 128, ...): column k = (3 * dy + dx) * cin + ci of a row is the
// observation at the tap's pixel, converted by Op (zero outside the board,
// past 9 * cin and on garbage rows).
template <class Op, int MT, int A_ROWS>
__device__ __forceinline__ void gather_stem(const ConvArgs& a, int t, int lt,
                                            uint8_t* dst) {
  using T = typename Op::Elem;
  constexpr int EPC = 16 / (int)sizeof(T);
  const Geometry& g = a.geo;
  const int b = t / g.segs;
  for (int r = lt; r < MT; r += 128) {
    const int rr = g.pitch + 1 + (t - b * g.segs) * MT + r;
    const int y = rr / g.pitch - 1;
    const int x = rr % g.pitch - 1;
    const bool live = rr < g.pitch + 1 + g.size * g.pitch && x >= 0 &&
                      x < g.size;
    T* row = reinterpret_cast<T*>(dst + (size_t)r * 16);
    int k = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = y + tap / 3 - 1;
      const int xx = x + tap % 3 - 1;
      const bool in = live && yy >= 0 && yy < g.size && xx >= 0 &&
                      xx < g.size;
      const float* src =
          a.obs + (((size_t)b * g.size + (in ? yy : 0)) * g.size +
                   (in ? xx : 0)) * a.cin;
      for (int ci = 0; ci < a.cin; ++ci, ++k)
        row[(k / EPC) * A_ROWS * EPC + k % EPC] =
            in ? Op::stem_value(src[ci], ci, a) : T{};
    }
    for (; k < a.ks; ++k) row[(k / EPC) * A_ROWS * EPC + k % EPC] = T{};
  }
}

// Issues one tile's MMAs for a warpgroup: MW m64 row blocks, all NS
// columns, every tap and 32-byte step of K.  A tap is a shift of A's start
// by dy * p + dx rows: the three dy shifts are computed, every other
// offset is a constant of the unrolled loop.
template <int NS, int TAPS, int KC, int MW, int A_ROWS, typename Acc>
__device__ __forceinline__ void issue_tile(Acc (&acc)[MW][NS / 2],
                                           uint32_t a_addr, uint64_t w_desc,
                                           int pitch) {
  uint64_t a_desc[3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
    a_desc[dy] = desc(a_addr + dy * pitch * 16, A_ROWS * 16, 128);
#pragma unroll
  for (int m = 0; m < MW; ++m) {
#pragma unroll
    for (int r = 0; r < NS / 2; ++r) acc[m][r] = Acc(0);
    fence_acc(acc[m]);
  }
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
#pragma unroll
    for (int k = 0; k < KC; k += 2)
#pragma unroll
      for (int m = 0; m < MW; ++m)
        wgmma(acc[m],
              a_desc[tap / 3] + (uint64_t)(k * A_ROWS + tap % 3 + m * 64),
              w_desc + (uint64_t)((tap * KC + k) * NS));
  }
  wgmma_commit();
}

// A tile's rows in one thread: per m64 block and h = 0, 1, the row
// 16 * warp + lane / 4 + 8h, whether it is a board pixel (garbage columns
// and rows past the band are not), its skip-track entry at the thread's
// first column, and its row in the output planes.
template <int MW>
struct TileRows {
  bool live[MW][2];
  float* skip[MW][2];
  uint8_t* out[MW][2];
};

template <int MODE, int MW>
__device__ __forceinline__ TileRows<MW> tile_rows(const ConvArgs& a,
                                                  const EpiArgs& e, int t,
                                                  int lt, int n0, int epc) {
  const Geometry& g = a.geo;
  const int b = t / g.segs;
  const int s = t - b * g.segs;
  const int band_end = g.pitch + 1 + g.size * g.pitch;
  TileRows<MW> rows;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m * 64 + (lt >> 5) * 16 + ((lt & 31) >> 2) + 8 * h;
      const int rr = g.pitch + 1 + s * g.mt + r;
      const int x = rr % g.pitch - 1;
      const int y = rr / g.pitch - 1;
      const bool live = rr < band_end && x >= 0 && x < g.size;
      const size_t pixel = live ? ((size_t)b * g.size + y) * g.size + x : 0;
      rows.live[m][h] = live;
      rows.skip[m][h] =
          MODE == CONV1 ? nullptr : e.skip + pixel * e.c + n0 + 2 * (lt & 3);
      rows.out[m][h] = MODE == CONV2_LAST
                           ? nullptr
                           : e.out + (size_t)(n0 / epc) * e.rows_total * 16 +
                                 ((size_t)b * g.board_rows + rr) * 16;
    }
  return rows;
}

// The skip values of a tile's rows (zero where the mode has no residual or
// the row is masked), loaded before the tile's MMAs wait, so that their
// latency runs under the MMAs.
template <int MODE, int NS, int MW>
__device__ __forceinline__ void load_skip(const TileRows<MW>& rows,
                                          float2 (&sv)[MW][NS / 8][2]) {
  constexpr bool RESIDUAL = MODE == CONV2 || MODE == CONV2_LAST;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sv[m][j][h] = RESIDUAL && rows.live[m][h]
                          ? *reinterpret_cast<const float2*>(
                                rows.skip[m][h] + 8 * j)
                          : make_float2(0.f, 0.f);
}

// Writes one tile from a warpgroup's accumulators: thread (warp, lane)
// holds rows 16 * warp + lane / 4 (+ 8) of each m64 block and column pairs
// 8j + 2 (lane % 4).  Every value is computed for masked rows too and only
// the stores are predicated, so no branch keeps the compiler from
// interleaving the columns' chains.  The skip track is written a column
// pair a thread (each row's 32 bytes of a j at once); a plane row's 16
// bytes are written by the row's four threads at once: in bf16 they hold
// them (8 columns of one j), in int8 they trade the 2-byte pairs of two
// j's with two shuffles first.
template <class Op, int NS, int MODE, int MW, typename Acc>
__device__ __forceinline__ void epilogue(const EpiArgs& e,
                                         const uint8_t* params,
                                         const TileRows<MW>& rows, int lt,
                                         Acc (&acc)[MW][NS / 2],
                                         const float2 (&sv)[MW][NS / 8][2]) {
  using T = typename Op::Elem;
  constexpr int EPC = 16 / (int)sizeof(T);
  const int q = lt & 3;
  const size_t plane = (size_t)e.rows_total * 16;
#pragma unroll
  for (int m = 0; m < MW; ++m) {
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const typename Op::Cols cp = Op::template cols<NS>(params, 8 * j + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = Op::template value<MODE>(
            cp, acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1],
            sv[m][j][h]);
        if (MODE != CONV1 && rows.live[m][h])
          *reinterpret_cast<float2*>(rows.skip[m][h] + 8 * j) = v;
        if constexpr (MODE != CONV2_LAST) {
          const uint32_t p = Op::pack(cp, v);
          if constexpr (EPC == 8) {
            if (rows.live[m][h])
              *reinterpret_cast<uint32_t*>(rows.out[m][h] + j * plane +
                                           4 * q) = p;
          } else if (j % 2 == 0) {
            // keep the even j's pair until the odd j's is packed
            acc[m][4 * j + 2 * h] = (Acc)p;
          } else {
            const uint32_t w =
                (uint32_t)acc[m][4 * (j - 1) + 2 * h] | (p << 16);
            const int src = (lt & 31 & ~3) + (2 * q) % 4;
            const uint32_t w0 = __shfl_sync(0xffffffffu, w, src);
            const uint32_t w1 = __shfl_sync(0xffffffffu, w, src + 1);
            // threads q = 0, 1 write the even j's bytes, q = 2, 3 the odd's
            const uint32_t word = __byte_perm(w0, w1, q < 2 ? 0x5410 : 0x7632);
            if (rows.live[m][h])
              *reinterpret_cast<uint32_t*>(rows.out[m][h] +
                                           (j / 2) * plane + 4 * q) = word;
          }
        }
      }
    }
  }
}

// Shared memory of a launch: the mbarriers, the epilogue's parameters, the
// weights, nb board buffers for each warpgroup.
__host__ __device__ constexpr int smem_bytes(int taps, int kc, int ns, int mt,
                                             int nb) {
  return HEADER + params_bytes(ns) + taps * kc * ns * 16 +
         2 * nb * kc * a_rows_max(mt) * 16;
}

// Board buffers a warpgroup has: two (the copy of the tile after next in
// flight) where they fit beside the weights, else one.
__host__ __device__ constexpr int board_buffers(int taps, int kc, int ns,
                                                int mt) {
  return smem_bytes(taps, kc, ns, mt, 2) <= SMEM_LIMIT ? 2 : 1;
}

// One conv: every tile of the launch's slice of output channels, the
// block's tiles alternating between its two warpgroups.  TAPS = 1 with K
// in KC chunks (the stem, A gathered) or 9 taps of KC chunks (a block conv,
// A copied).
template <class Op, int NS, int MODE, int KC, int MW>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const ConvArgs a, const EpiArgs e) {
  using Acc = typename Op::Acc;
  constexpr int TAPS = MODE == STEM ? 1 : 9;
  constexpr int MT = 64 * MW;
  constexpr int A_ROWS = a_rows_max(MT);
  constexpr int A_BYTES = KC * A_ROWS * 16;
  constexpr int NB = board_buffers(TAPS, KC, NS, MT);
  constexpr int EPC = 16 / (int)sizeof(typename Op::Elem);
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* const params = smem + HEADER;
  uint8_t* const sw = params + params_bytes(NS);
  const Geometry& g = a.geo;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lt = tid & 127;
  const int n0 = (blockIdx.x % a.n_slices) * NS;
  const int first = blockIdx.x / a.n_slices;
  const int stride = gridDim.x / a.n_slices;
  const int n_local =
      first < g.n_tiles ? (g.n_tiles - first + stride - 1) / stride : 0;
  uint8_t* const abufs = sw + TAPS * KC * NS * 16 + wg * NB * A_BYTES;
  uint64_t* const abars = &bars[wg * NB];   // this warpgroup's buffers
  uint64_t* const wbar = &bars[4];          // the weights

  if (tid == 0) {
    for (int i = 0; i < 2 * NB; ++i) mbar_init(&bars[i], 1);
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Op::load_params(e, n0, NS, params);
  __syncthreads();  // barriers initialised, parameters stored
  // the slice's weights, once, one bulk copy a tap ([tap][chunk][NS][16
  // bytes], as ops/conv_tile.py tile_weights lays them out)
  constexpr int TAP_BYTES = KC * NS * 16;
  if (tid == 0) {
    const uint8_t* wsrc =
        a.w + (size_t)(blockIdx.x % a.n_slices) * TAPS * TAP_BYTES;
    mbar_expect_tx(wbar, TAPS * TAP_BYTES);
    for (int tap = 0; tap < TAPS; ++tap)
      bulk_copy(sw + tap * TAP_BYTES, wsrc + (size_t)tap * TAP_BYTES,
                TAP_BYTES, wbar);
  }
  // the next conv may launch now; this one reads the previous conv's
  // output, and writes what it reads, only once that conv is complete
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (MODE != STEM && lt == 0)
    for (int i = 0; i < NB && wg + 2 * i < n_local; ++i)
      load_tile<A_ROWS>(a, first + (wg + 2 * i) * stride, abufs + i * A_BYTES,
                        &abars[i]);
  // tile 0's warpgroup takes the first turn on the tensor cores
  if (wg == 1 && n_local > 0) named_arrive(BAR_MMA, 2 * 128);
  mbar_wait(wbar, 0);

  const uint64_t w_desc = desc(smem_u32(sw), NS * 16, 128);
  Acc acc[MW][NS / 2];
  int j = 0;
  for (int k = wg; k < n_local; k += 2, ++j) {
    const int t = first + k * stride;
    uint8_t* const abuf = abufs + (j % NB) * A_BYTES;
    uint64_t* const bar = &abars[j % NB];
    const TileRows<MW> rows = tile_rows<MODE, MW>(a, e, t, lt, n0, EPC);
    float2 sv[MW][NS / 8][2];
    load_skip<MODE, NS, MW>(rows, sv);
    if constexpr (MODE == STEM) {
      gather_stem<Op, MT, A_ROWS>(a, t, lt, abuf);
      fence_proxy_async();
      named_sync(BAR_WG + wg, 128);
    } else {
      mbar_wait(bar, (uint32_t)(j / NB) & 1u);
    }
    named_sync(BAR_MMA + wg, 2 * 128);
    issue_tile<NS, TAPS, KC, MW, A_ROWS>(acc, smem_u32(abuf), w_desc,
                                         MODE == STEM ? 0 : g.pitch);
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < MW; ++m) fence_acc(acc[m]);
    // the next tile's warpgroup may take the tensor cores
    if (k + 1 < n_local) named_arrive(BAR_MMA + 1 - wg, 2 * 128);
    named_sync(BAR_WG + wg, 128);  // the warpgroup is done with abuf
    if (MODE != STEM && lt == 0 && k + 2 * NB < n_local)
      load_tile<A_ROWS>(a, first + (k + 2 * NB) * stride, abuf, bar);
    epilogue<Op, NS, MODE, MW>(e, params, rows, lt, acc, sv);
  }
}

// Launches one conv on a persistent grid: per slice of NS output channels,
// one block an SM (at most one a tile).  Returns a CUDA error code.
template <class Op, int NS, int MODE, int KC, int MW>
int launch_conv(const ConvArgs& a, const EpiArgs& e, cudaStream_t stream) {
  constexpr int TAPS = MODE == STEM ? 1 : 9;
  const int bytes = smem_bytes(TAPS, KC, NS, 64 * MW,
                               board_buffers(TAPS, KC, NS, 64 * MW));
  if (bytes > SMEM_LIMIT || a.kc != KC || a.geo.mt != 64 * MW ||
      a.geo.a_rows > a_rows_max(64 * MW) || a.n_slices < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_kernel<Op, NS, MODE, KC, MW>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per_slice = sms / a.n_slices;
  if (per_slice < 1) per_slice = 1;
  if (per_slice > a.geo.n_tiles) per_slice = a.geo.n_tiles;
  // programmatic dependent launch: the block's set-up (barriers, epilogue
  // parameters, the weights' copy) overlaps the previous kernel's end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(per_slice * a.n_slices);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, a, e);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The stem: one tap of K = kc chunks, kc of 2, 4, 6 or 8.
template <class Op, int NS, int MW>
int launch_stem(const ConvArgs& a, const EpiArgs& e, cudaStream_t stream) {
  switch (a.kc) {
    case 2: return launch_conv<Op, NS, STEM, 2, MW>(a, e, stream);
    case 4: return launch_conv<Op, NS, STEM, 4, MW>(a, e, stream);
    case 6: return launch_conv<Op, NS, STEM, 6, MW>(a, e, stream);
    case 8: return launch_conv<Op, NS, STEM, 8, MW>(a, e, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace conv_tile
