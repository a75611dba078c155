// The residual tower of the policy/value net for Hopper (sm_90a), eval mode
// with BatchNorm folded into the convolutions: fused_tower.
//
// Replaces the Pallas kernel alphazero_gomoku_tpu/ops/fused_net.py
// fused_predict (body _fused_kernel): stem conv, then L residual blocks
// relu(conv2(relu(conv1(x))) + x), every conv a 3x3 SAME conv plus bias.
// Numerics as there: activations and the residual track in float32; each
// conv rounds its input to bfloat16, multiplies by bfloat16 weights and sums
// in float32; bias, ReLU and the residual add in float32.
//
// Layouts (as ops/fused_net.py documents them): activations NHWC float32
// [B, H, W, C]; stem weights [9, cin, C] bf16, block weights [L, 2, 9, C, C]
// bf16 (tap k = 3 * dy + dx, then [in, out]); biases float32.
//
// Design: one launch per conv, activations in global memory between them
// (at batch 256 and 6x128 one activation buffer is 29.5 MB and stays in the
// 50 MB L2).  A block conv is an implicit GEMM: M = B*H*W pixels, N = C
// output channels, K = 9 taps x C input channels.  A thread block of 8 warps
// computes a 64-pixel x C tile with nvcuda::wmma bf16 16x16x16 fragments and
// float32 accumulators: per tap and 32-channel chunk it gathers the shifted
// pixels (zero outside the board, rounded to bf16) and the weight rows into
// shared memory, then each warp multiplies its 16-row x C/2 slice.  The
// epilogue goes through shared memory to add bias and residual and write
// coalesced float32 rows.  The stem (cin = 3 real channels, K = 27) is a
// plain CUDA-core loop, one thread per output.
//
// What bounds it on the card: the FLOPs, 2*B*H*W*9*C*C per block conv, over
// the bf16 tensor-core rate; the simple design here (no TMA, no wgmma, two
// block-wide barriers per 32-channel chunk, 9x re-reads of each activation
// from L2) reaches a fraction of it.  wgmma, TMA and keeping a tile's
// activations on chip across layers are for a later PR.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3,
// FMA contraction allowed).  The entry point launches every conv on the
// stream it is given and returns the first cudaGetLastError() != 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;        // pixels per block
constexpr int KC = 32;        // input channels per shared-memory chunk
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int STEM_THREADS = 128;

// Shared memory of one conv block: the bf16 A and B tiles of a chunk, and,
// reusing the same bytes after the last chunk, the float32 output tile.
template <int C>
struct ConvSmem {
  static constexpr int LDA = KC + 8;   // bf16 row pitch, a multiple of 8
  static constexpr int LDB = C + 8;
  static constexpr int LDO = C + 4;    // float row pitch, a multiple of 4
  static constexpr int A_BYTES = BM * LDA * 2;  // a multiple of 32
  static constexpr int IN_BYTES = A_BYTES + KC * LDB * 2;
  static constexpr int OUT_BYTES = BM * LDO * 4;
  static constexpr int BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
};

// out[p, co] = act(bias[co] + sum_{tap, ci} bf16(in[p + shift(tap), ci]) *
//                  w[tap, ci, co] (+ residual[p, co]))
// residual may alias out (each element is read by the thread that writes it).
template <int C>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ in, const bf16* __restrict__ w,
               const float* __restrict__ bias, const float* residual,
               float* out, int n_pix, int height, int width) {
  __shared__ __align__(32) unsigned char smem[ConvSmem<C>::BYTES];
  bf16* const sa = reinterpret_cast<bf16*>(smem);
  bf16* const sb = reinterpret_cast<bf16*>(smem + ConvSmem<C>::A_BYTES);
  float* const so = reinterpret_cast<float*>(smem);
  constexpr int LDA = ConvSmem<C>::LDA;
  constexpr int LDB = ConvSmem<C>::LDB;
  constexpr int LDO = ConvSmem<C>::LDO;
  constexpr int WN = C / 2;        // columns per warp
  constexpr int NF = WN / 16;      // accumulator fragments per warp
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int p0 = blockIdx.x * BM;
  const int hw = height * width;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += KC) {
      // A: 64 shifted pixels x 32 channels, float4 loads, rounded to bf16
      for (int i = tid; i < BM * KC / 4; i += THREADS) {
        const int r = i / (KC / 4);
        const int q = i % (KC / 4);
        const int p = p0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < n_pix) {
          const int b = p / hw;
          const int rem = p - b * hw;
          const int y = rem / width + dy;
          const int x = rem % width + dx;
          if (y >= 0 && y < height && x >= 0 && x < width)
            v = *reinterpret_cast<const float4*>(
                in + ((size_t)b * hw + y * width + x) * C + c0 + 4 * q);
        }
        bf16* dst = sa + r * LDA + 4 * q;
        dst[0] = __float2bfloat16_rn(v.x);
        dst[1] = __float2bfloat16_rn(v.y);
        dst[2] = __float2bfloat16_rn(v.z);
        dst[3] = __float2bfloat16_rn(v.w);
      }
      // B: 32 weight rows x C, 16-byte loads
      const bf16* wt = w + ((size_t)tap * C + c0) * C;
      for (int i = tid; i < KC * C / 8; i += THREADS) {
        const int r = i / (C / 8);
        const int q = i % (C / 8);
        *reinterpret_cast<uint4*>(sb + r * LDB + 8 * q) =
            *reinterpret_cast<const uint4*>(wt + (size_t)r * C + 8 * q);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sa + wm * 16 * LDA + kk, LDA);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, sb + kk * LDB + wn * WN + f * 16,
                                 LDB);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(so + wm * 16 * LDO + wn * WN + f * 16, acc[f],
                            LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * C; i += THREADS) {
    const int r = i / C;
    const int col = i % C;
    const int p = p0 + r;
    if (p >= n_pix) continue;
    const size_t o = (size_t)p * C + col;
    float v = so[r * LDO + col] + bias[col];
    if (residual != nullptr) v = v + residual[o];
    out[o] = fmaxf(v, 0.f);
  }
}

// Stem: out[p, co] = relu(bias[co] + sum_{tap, ci < cin}
//                         bf16(obs[p + shift(tap), ci]) * w[tap, ci, co]).
// 32-bit indices: the wrapper checks that B*H*W*C fits.
__global__ void __launch_bounds__(STEM_THREADS)
stem_kernel(const float* __restrict__ obs, const bf16* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            int n_pix, int height, int width, int cin, int c) {
  const int i = blockIdx.x * STEM_THREADS + threadIdx.x;
  if (i >= n_pix * c) return;
  const int p = i / c;
  const int co = i - p * c;
  const int hw = height * width;
  const int b = p / hw;
  const int rem = p - b * hw;
  const int y0 = rem / width;
  const int x0 = rem - y0 * width;
  float acc = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int y = y0 + tap / 3 - 1;
    const int x = x0 + tap % 3 - 1;
    if (y < 0 || y >= height || x < 0 || x >= width) continue;
    const float* src = obs + (b * hw + y * width + x) * cin;
    const bf16* wt = w + tap * cin * c + co;
    for (int ci = 0; ci < cin; ++ci)
      acc += __bfloat162float(__float2bfloat16_rn(src[ci])) *
             __bfloat162float(wt[ci * c]);
  }
  out[i] = fmaxf(acc + bias[co], 0.f);
}

template <int C>
int launch_blocks(const bf16* block_w, const float* block_b, int n_blocks,
                  float* act_a, float* act_b, int n_pix, int height,
                  int width, cudaStream_t stream) {
  const int grid = (n_pix + BM - 1) / BM;
  for (int i = 0; i < n_blocks; ++i) {
    const bf16* w1 = block_w + (size_t)(2 * i) * 9 * C * C;
    const bf16* w2 = block_w + (size_t)(2 * i + 1) * 9 * C * C;
    const float* b1 = block_b + (size_t)(2 * i) * C;
    const float* b2 = block_b + (size_t)(2 * i + 1) * C;
    conv3x3_kernel<C><<<grid, THREADS, 0, stream>>>(act_a, w1, b1, nullptr,
                                                    act_b, n_pix, height,
                                                    width);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    conv3x3_kernel<C><<<grid, THREADS, 0, stream>>>(act_b, w2, b2, act_a,
                                                    act_a, n_pix, height,
                                                    width);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The tower: act_a <- stem(obs), then per block act_b <- relu(conv1(act_a)),
// act_a <- relu(conv2(act_b) + act_a).  The result is left in act_a.
// Returns 0, or the CUDA error of the first launch that failed; a C other
// than 64 or 128 returns cudaErrorInvalidValue.
extern "C" int fused_tower_launch(const float* obs, int batch, int height,
                                  int width, int cin, int c, int n_blocks,
                                  const bf16* stem_w, const float* stem_b,
                                  const bf16* block_w, const float* block_b,
                                  float* act_a, float* act_b, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_pix = batch * height * width;
  const int stem_grid = (n_pix * c + STEM_THREADS - 1) / STEM_THREADS;
  stem_kernel<<<stem_grid, STEM_THREADS, 0, s>>>(obs, stem_w, stem_b, act_a,
                                                 n_pix, height, width, cin, c);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (c == 128)
    return launch_blocks<128>(block_w, block_b, n_blocks, act_a, act_b,
                              n_pix, height, width, s);
  if (c == 64)
    return launch_blocks<64>(block_w, block_b, n_blocks, act_a, act_b, n_pix,
                             height, width, s);
  return (int)cudaErrorInvalidValue;
}
