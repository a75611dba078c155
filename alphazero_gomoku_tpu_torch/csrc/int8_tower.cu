// The int8 residual tower of the policy/value net for Hopper (sm_90a), eval
// mode with BatchNorm folded and activation scales folded into the weights:
// int8_tower.
//
// Replaces the Pallas kernel alphazero_gomoku_tpu/ops/int8_tower.py
// int8_tower_apply (body _tower_kernel): the stem conv on the requantized
// observation, then L residual blocks relu(conv2(relu(conv1(x))) + x), every
// conv a 3x3 SAME conv as int8 x int8 -> int32 sums with a per-Cout dequant,
// bias, ReLU and per-channel requant to int8 in its epilogue, and the skip
// track in float32.  Equal bit for bit to the plain version
// (ops/int8_tower.py int8_tower_plain) and to ops/int8_net.py int8_apply:
// the integer sums are exact in any order, and every float step is the same
// IEEE operation in the same order -
//   obs requant    q = clamp(rint(x * inv), -127, 127)      (float32)
//   dequant        y = float(double(float(acc)) * scale + bias),
//                      the product exact in float64, one rounding to float32
//   ReLU, skip     h = max(y + skip, 0)                      (float32)
//   requant        as the obs requant, rint rounding half to even
// with explicit __fmul_rn / __fadd_rn / __dmul_rn / __dadd_rn, built with
// --fmad=false, so that nothing is contracted.
//
// Layouts (as ops/int8_tower.py documents them): activations NHWC, the conv
// inputs int8 [B, H, W, C] and the skip track float32; stem weights [C, KS]
// int8, column (3*dy + dx) * cin + ci, zero past 9 * cin; block weights
// [L, 2, C, 9 * C] int8, column (3*dy + dx) * C + ci; per-channel scales,
// biases and requant reciprocals float32.
//
// Design: one launch per conv, int8 activations and the float32 skip track in
// global memory between them (at batch 256 and 6x128 an int8 activation is
// 7.4 MB and the skip track 29.5 MB: both stay in the 50 MB L2).  A conv is
// an implicit GEMM, M = B*H*W pixels, N = C output channels, K = 9 taps x C
// input channels.  A thread block of 8 warps computes a 128-pixel x C tile
// with mma.sync m16n8k32 int8 tensor-core instructions and int32
// accumulators: per tap it stages the 128 shifted pixels' C channels (zero
// outside the board) and the tap's [C, C] weights in shared memory (16 KB
// each at C = 128, rows padded by 16 bytes so that the fragment loads hit 32
// distinct banks), then each warp multiplies its 32-row x C/2 slice, 32 deep
// at a time.  The epilogue works from the accumulator fragments.  The stem
// is the same GEMM with K = 9 * cin padded to a multiple of 32, its A tile
// gathered from the float32 observation and requantized on the way; it
// reads each observation value once per tile, for all C outputs.
//
// What bounds it on the card: the operations, 2*B*H*W*9*C*C per block conv,
// over the dense int8 tensor-core rate.  This simple design (mma.sync, not
// wgmma; synchronous staging with two block-wide barriers per tap; the
// activations re-read nine times from L2) reaches a fraction of it.  wgmma,
// TMA and keeping a tile's activations on chip across layers are for a later
// PR.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false).  The entry point launches every conv on the stream it is
// given and returns the first cudaGetLastError() != 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // pixels per block
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int PAD = 16;       // shared-memory row padding in bytes

enum Mode { STEM, CONV1, CONV2, CONV2_LAST };

__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  const double prod = __dmul_rn((double)__int2float_rn(acc), (double)scale);
  return __double2float_rn(__dadd_rn(prod, (double)bias));
}

__device__ __forceinline__ int8_t requant(float x, float inv) {
  const float v = fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f);
  return (int8_t)__float2int_rn(v);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One conv of the tower over a 128-pixel tile.  K is staged KT deep per
// chunk: a block conv has 9 chunks (one tap each, KT = C), the stem
// n_chunks chunks of KT = 32 over its flattened (tap, ci) columns.
//   STEM       : h = relu(dq(acc));        skip = h; out_q = rq(h, inv_out)
//   CONV1      : m = relu(dq(acc));        out_q = rq(m, inv_out)
//   CONV2      : h = relu(dq(acc) + skip); skip = h; out_q = rq(h, inv_out)
//   CONV2_LAST : h = relu(dq(acc) + skip); skip = h
// skip is read and written by the same thread, element by element.
template <int C, int KT, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
int8_conv_kernel(const int8_t* __restrict__ in_q,
                 const float* __restrict__ obs,
                 const float* __restrict__ inv_obs, int cin, int n_chunks,
                 const int8_t* __restrict__ w, int k_row,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ inv_out, float* skip,
                 int8_t* __restrict__ out_q, int n_pix, int height,
                 int width) {
  constexpr int LD = KT + PAD;
  constexpr int NT = C / 16;      // n8 tiles per warp (a warp has C/2 columns)
  __shared__ __align__(16) int8_t sa[BM * LD];
  __shared__ __align__(16) int8_t sb[C * LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;        // the fragment's group (row / column)
  const int t = lane & 3;         // its thread in the group
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int p0 = blockIdx.x * BM;
  const int hw = height * width;

  int acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if constexpr (MODE == STEM) {
      // A: the tile's (tap, ci) columns chunk*32 .. +32, requantized obs
      for (int i = tid; i < BM * KT; i += THREADS) {
        const int r = i / KT;
        const int kk = i % KT;
        const int k = chunk * KT + kk;
        const int p = p0 + r;
        int8_t v = 0;
        if (p < n_pix && k < 9 * cin) {
          const int tap = k / cin;
          const int ci = k - tap * cin;
          const int b = p / hw;
          const int rem = p - b * hw;
          const int y = rem / width + tap / 3 - 1;
          const int x = rem % width + tap % 3 - 1;
          if (y >= 0 && y < height && x >= 0 && x < width)
            v = requant(obs[(b * hw + y * width + x) * cin + ci], inv_obs[ci]);
        }
        sa[r * LD + kk] = v;
      }
    } else {
      // A: the tile's pixels shifted by the tap, C channels, 16-byte loads
      const int dy = chunk / 3 - 1;
      const int dx = chunk % 3 - 1;
      for (int i = tid; i < BM * (KT / 16); i += THREADS) {
        const int r = i / (KT / 16);
        const int q = i % (KT / 16);
        const int p = p0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p < n_pix) {
          const int b = p / hw;
          const int rem = p - b * hw;
          const int y = rem / width + dy;
          const int x = rem % width + dx;
          if (y >= 0 && y < height && x >= 0 && x < width)
            v = *reinterpret_cast<const uint4*>(
                in_q + (size_t)(b * hw + y * width + x) * C + 16 * q);
        }
        *reinterpret_cast<uint4*>(sa + r * LD + 16 * q) = v;
      }
    }
    // B: the chunk's KT columns of every output channel's weight row
    for (int i = tid; i < C * (KT / 16); i += THREADS) {
      const int r = i / (KT / 16);
      const int q = i % (KT / 16);
      *reinterpret_cast<uint4*>(sb + r * LD + 16 * q) =
          *reinterpret_cast<const uint4*>(w + (size_t)r * k_row +
                                          chunk * KT + 16 * q);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = sa + (wm * 32 + mi * 16 + g) * LD + kk + 4 * t;
        a[mi][0] = lds32(base);
        a[mi][1] = lds32(base + 8 * LD);
        a[mi][2] = lds32(base + 16);
        a[mi][3] = lds32(base + 8 * LD + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int8_t* base =
            sb + (wn * (C / 2) + ni * 8 + g) * LD + kk + 4 * t;
        const uint32_t b0 = lds32(base);
        const uint32_t b1 = lds32(base + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: accumulator element e of tile (mi, ni) is row g + 8 * (e >> 1),
  // column 2 * t + (e & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 32 + mi * 16 + g + 8 * half;
      if (p >= n_pix) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int col = wn * (C / 2) + ni * 8 + 2 * t;
        const size_t o = (size_t)p * C + col;
        float h0 = dequant(acc[mi][ni][2 * half], scale[col], bias[col]);
        float h1 =
            dequant(acc[mi][ni][2 * half + 1], scale[col + 1], bias[col + 1]);
        if constexpr (MODE == CONV2 || MODE == CONV2_LAST) {
          const float2 s = *reinterpret_cast<const float2*>(skip + o);
          h0 = __fadd_rn(h0, s.x);
          h1 = __fadd_rn(h1, s.y);
        }
        h0 = fmaxf(h0, 0.f);
        h1 = fmaxf(h1, 0.f);
        if constexpr (MODE != CONV1)
          *reinterpret_cast<float2*>(skip + o) = make_float2(h0, h1);
        if constexpr (MODE != CONV2_LAST)
          *reinterpret_cast<char2*>(out_q + o) = make_char2(
              requant(h0, inv_out[col]), requant(h1, inv_out[col + 1]));
      }
    }
  }
}

template <int C>
int launch_tower(const float* obs, int n_pix, int height, int width, int cin,
                 int n_blocks, int ks, const int8_t* stem_w,
                 const float* stem_scale, const float* stem_b,
                 const float* inv_obs, const float* inv_first,
                 const int8_t* block_w, const float* block_scale,
                 const float* block_b, const float* inv_mid,
                 const float* inv_next, int8_t* act_q, int8_t* mid_q,
                 float* out, cudaStream_t s) {
  const int grid = (n_pix + BM - 1) / BM;
  int8_conv_kernel<C, 32, STEM><<<grid, THREADS, 0, s>>>(
      nullptr, obs, inv_obs, cin, ks / 32, stem_w, ks, stem_scale, stem_b,
      inv_first, out, act_q, n_pix, height, width);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t wsize = (size_t)C * 9 * C;
  for (int i = 0; i < n_blocks; ++i) {
    int8_conv_kernel<C, C, CONV1><<<grid, THREADS, 0, s>>>(
        act_q, nullptr, nullptr, 0, 9, block_w + (2 * i) * wsize, 9 * C,
        block_scale + (2 * i) * C, block_b + (2 * i) * C, inv_mid + i * C,
        nullptr, mid_q, n_pix, height, width);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int8_t* w2 = block_w + (2 * i + 1) * wsize;
    const float* s2 = block_scale + (2 * i + 1) * C;
    const float* b2 = block_b + (2 * i + 1) * C;
    if (i + 1 < n_blocks)
      int8_conv_kernel<C, C, CONV2><<<grid, THREADS, 0, s>>>(
          mid_q, nullptr, nullptr, 0, 9, w2, 9 * C, s2, b2, inv_next + i * C,
          out, act_q, n_pix, height, width);
    else
      int8_conv_kernel<C, C, CONV2_LAST><<<grid, THREADS, 0, s>>>(
          mid_q, nullptr, nullptr, 0, 9, w2, 9 * C, s2, b2, nullptr, out,
          nullptr, n_pix, height, width);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The tower: out <- stem(obs) with act_q <- its requant, then per block
// mid_q <- rq(relu(conv1(act_q))), out <- relu(conv2(mid_q) + out) with
// act_q <- its requant (not after the last block).  The result is left in
// out.  Returns 0, or the CUDA error of the first launch that failed; a C
// other than 32, 64 or 128, or a KS that is not a multiple of 32, returns
// cudaErrorInvalidValue.
extern "C" int int8_tower_launch(
    const float* obs, int batch, int height, int width, int cin, int c,
    int n_blocks, int ks, const int8_t* stem_w, const float* stem_scale,
    const float* stem_b, const float* inv_obs, const float* inv_first,
    const int8_t* block_w, const float* block_scale, const float* block_b,
    const float* inv_mid, const float* inv_next, int8_t* act_q,
    int8_t* mid_q, float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_pix = batch * height * width;
  if (ks % 32 != 0 || ks < 9 * cin) return (int)cudaErrorInvalidValue;
#define INT8_TOWER_ARGS                                                     \
  obs, n_pix, height, width, cin, n_blocks, ks, stem_w, stem_scale, stem_b, \
      inv_obs, inv_first, block_w, block_scale, block_b, inv_mid, inv_next, \
      act_q, mid_q, out, s
  if (c == 128) return launch_tower<128>(INT8_TOWER_ARGS);
  if (c == 64) return launch_tower<64>(INT8_TOWER_ARGS);
  if (c == 32) return launch_tower<32>(INT8_TOWER_ARGS);
#undef INT8_TOWER_ARGS
  return (int)cudaErrorInvalidValue;
}
