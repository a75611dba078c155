// The residual tower of the policy/value net for Hopper (sm_90a), eval mode
// with BatchNorm folded into the convolutions: fused_tower.
//
// Replaces the Pallas kernel alphazero_gomoku_tpu/ops/fused_net.py
// fused_predict (body _fused_kernel): stem conv, then L residual blocks
// relu(conv2(relu(conv1(x))) + x), every conv a 3x3 SAME conv plus bias.
// Numerics as there: each conv rounds its input to bfloat16, multiplies by
// bfloat16 weights and sums in float32; bias, ReLU and the residual add in
// float32, the residual track in float32.  Only the order of summation
// differs from the plain version (ops/fused_net.py fused_tower_plain).
//
// Layouts: the observation and the output NHWC float32.  The weights are
// the folded bundle's (stem [9, cin, C], blocks [L, 2, 9, C, C] bf16, [in,
// out] per tap) re-packed once per bundle by the wrapper (ops/fused_net.py
// kmajor_weights) into K-contiguous rows, as wgmma's B wants them: stem [C,
// KS], column (3*dy + dx) * cin + ci, zero past 9 * cin, KS = 9 * cin
// rounded up to 16; blocks [L, 2, C, 9 * C], column (3*dy + dx) * C + ci;
// then laid out tap by tap for the kernel's bulk copies
// (ops/conv_tile.py tile_weights).  The conv inputs are bf16 padded-board
// chunk planes (csrc/conv_tile.cuh), zeroed once by the wrapper: conv1's
// output feeds only conv2, which rounds it to bf16 anyway, so it is stored
// as bf16(relu(conv1)), bit-identical inputs at half the bytes; the stem
// and conv2 write the float32 residual track (the output buffer) and its
// bf16 copy, the next conv1's input.
//
// Design: one launch per conv on the shared core csrc/conv_tile.cuh (64-row
// padded-board tiles staged once per conv by bulk copies on mbarriers,
// wgmma m64n64k16 bf16 -> f32 from shared memory, two warpgroups taking
// turns on the tensor cores, persistent blocks).  The nine taps of a conv
// take 295 KB at C = 128, more than a block's 227 KB, so a block owns one
// slice of 64 output channels (147 KB of weights, resident for the launch)
// and stages the board rows for it; the two slices of a tile run on two
// blocks, and each warpgroup has one 28 KB board buffer.  The epilogue
// (Bf16Op) works from the accumulator registers.  The stem is the same GEMM
// with one tap of K = KS, its A tile gathered from the float32 observation
// and rounded to bf16.
//
// What bounds it on the card: the operations, 2*B*H*W*9*C*C per block conv,
// over the dense bf16 tensor-core rate (989 TFLOP/s); the tile computes
// 256 rows per 225 pixels at 15x15, and the n64 instruction reads its A and
// B from shared memory as fast as shared memory delivers them.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3,
// FMA contraction allowed).  The entry point launches every conv on the
// stream it is given and returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

constexpr int NS = 64;  // output channels a block
constexpr int MW = 1;   // tiles of 64 rows (conv_tile.cuh)

// The bf16 tower's element types, stem conversion and epilogue values:
//   STEM       : h = relu(acc + b);        skip = h; out = bf16(h)
//   CONV1      : m = relu(acc + b);        out = bf16(m)
//   CONV2      : h = relu(acc + b + skip); skip = h; out = bf16(h)
//   CONV2_LAST : h = relu(acc + b + skip); skip = h
// skip is read and written by the same thread, element by element.
struct Bf16Op {
  using Elem = bf16;
  using Acc = float;
  struct Cols {
    float2 bias;
  };

  static __device__ __forceinline__ bf16 stem_value(float x, int,
                                                    const ConvArgs&) {
    return __float2bfloat16_rn(x);
  }

  // the bias of the block's NS channels, in shared memory
  static __device__ __forceinline__ void load_params(const EpiArgs& e, int n0,
                                                     int ns, uint8_t* p) {
    float* bias = reinterpret_cast<float*>(p);
    for (int c = threadIdx.x; c < ns; c += THREADS) bias[c] = e.bias[n0 + c];
  }

  template <int NS_>
  static __device__ __forceinline__ Cols cols(const uint8_t* p, int cl) {
    return Cols{*reinterpret_cast<const float2*>(
        reinterpret_cast<const float*>(p) + cl)};
  }

  // h = relu(acc + b (+ skip)) for a column pair
  template <int MODE>
  static __device__ __forceinline__ float2 value(const Cols& cp, float a0,
                                                 float a1, float2 s) {
    float h0 = a0 + cp.bias.x;
    float h1 = a1 + cp.bias.y;
    if constexpr (MODE == CONV2 || MODE == CONV2_LAST) {
      h0 = h0 + s.x;
      h1 = h1 + s.y;
    }
    return make_float2(fmaxf(h0, 0.f), fmaxf(h1, 0.f));
  }

  // the pair rounded to bf16
  static __device__ __forceinline__ uint32_t pack(const Cols&, float2 h) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(h.x, h.y);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// The tower's convs after the stem, KC = C / 8 chunks of K a tap.
template <int KC>
int launch_blocks(ConvArgs a, int c, int n_blocks, const bf16* block_w,
                  const float* block_b, uint8_t* act, uint8_t* mid,
                  float* out, cudaStream_t s) {
  const Geometry& geo = a.geo;
  a.kc = KC;
  const size_t wsize = (size_t)c * 9 * c;
  for (int i = 0; i < n_blocks; ++i) {
    a.act = act;
    a.w = reinterpret_cast<const uint8_t*>(block_w + (2 * i) * wsize);
    EpiArgs e{nullptr, block_b + (2 * i) * c, nullptr, nullptr, mid, c,
              geo.rows_total};
    int err = launch_conv<Bf16Op, NS, CONV1, KC, MW>(a, e, s);
    if (err != 0) return err;
    a.act = mid;
    a.w = reinterpret_cast<const uint8_t*>(block_w + (2 * i + 1) * wsize);
    const float* b2 = block_b + (2 * i + 1) * c;
    if (i + 1 < n_blocks) {
      e = EpiArgs{nullptr, b2, nullptr, out, act, c, geo.rows_total};
      err = launch_conv<Bf16Op, NS, CONV2, KC, MW>(a, e, s);
    } else {
      e = EpiArgs{nullptr, b2, nullptr, out, nullptr, c, geo.rows_total};
      err = launch_conv<Bf16Op, NS, CONV2_LAST, KC, MW>(a, e, s);
    }
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The tower on square boards of side `size`: out <- stem(obs) with act <-
// its bf16 copy, then per block mid <- bf16(relu(conv1(act))), out <-
// relu(conv2(mid) + out) with act <- its bf16 copy (not after the last
// block).  The result is left in out (NHWC float32).  act and mid are
// zeroed chunk planes of rows_total rows (conv_tile::geometry).  Returns 0,
// or the CUDA error of the first launch that failed; a C other than 64 or
// 128, a KS that is not a multiple of 16 below 9 * cin or above 64, a
// rows_total that is not the geometry's, or a board too large for shared
// memory returns cudaErrorInvalidValue.
extern "C" int fused_tower_launch(const float* obs, int batch, int size,
                                  int cin, int c, int n_blocks, int ks,
                                  const bf16* stem_w, const float* stem_b,
                                  const bf16* block_w, const float* block_b,
                                  bf16* act, bf16* mid, int rows_total,
                                  float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Geometry geo = geometry(batch, size, 64 * MW);
  if ((c != 64 && c != 128) || ks % 16 != 0 || ks < 9 * cin || ks > 64 ||
      batch < 1 || rows_total != geo.rows_total)
    return (int)cudaErrorInvalidValue;
  uint8_t* act8 = reinterpret_cast<uint8_t*>(act);
  uint8_t* mid8 = reinterpret_cast<uint8_t*>(mid);
  ConvArgs a{};
  a.geo = geo;
  a.n_slices = c / NS;
  a.obs = obs;
  a.cin = cin;
  a.ks = ks;
  a.w = reinterpret_cast<const uint8_t*>(stem_w);
  a.kc = ks / 8;
  EpiArgs e{nullptr, stem_b, nullptr, out, act8, c, geo.rows_total};
  const int err = launch_stem<Bf16Op, NS, MW>(a, e, s);
  if (err != 0) return err;
  if (c == 128)
    return launch_blocks<16>(a, c, n_blocks, block_w, block_b, act8, mid8,
                             out, s);
  return launch_blocks<8>(a, c, n_blocks, block_w, block_b, act8, mid8, out,
                          s);
}
