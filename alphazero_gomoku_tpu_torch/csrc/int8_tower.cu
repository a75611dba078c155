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
// with explicit intrinsics (__fmul_rn, __fadd_rn, and the double __fma_rn,
// which rounds the exact product plus the bias once, as the multiply and
// add of the plain version do), built with --fmad=false, so that nothing
// else is contracted.
//
// Layouts (as ops/int8_tower.py documents them): the observation and the
// output NHWC float32; stem weights [C, KS] int8, column (3*dy + dx) * cin +
// ci, zero past 9 * cin; block weights [L, 2, C, 9 * C] int8, column
// (3*dy + dx) * C + ci: K-contiguous rows, as wgmma's B wants them, which
// the wrapper re-lays once per bundle tap by tap for the kernel's bulk
// copies (ops/conv_tile.py tile_weights).  The conv inputs (act_q, mid_q)
// are int8 padded-board chunk planes (csrc/conv_tile.cuh), zeroed once by
// the wrapper; the float32 skip track is the output buffer.
//
// Design: one launch per conv on the shared core csrc/conv_tile.cuh (64-row
// padded-board tiles staged once per conv by bulk copies on mbarriers, the
// conv's nine [C, C] weight taps resident in shared memory for the launch,
// wgmma m64nCk32 s8 -> s32 from shared memory, two warpgroups taking turns
// on the tensor cores, persistent blocks).  At C = 128 the nine taps take
// 147 KB, and two 14 KB board buffers a warpgroup fit beside them.  The
// epilogue (Int8Op) works from the accumulator registers: dequant, skip,
// ReLU, requant into the next conv's planes, the float steps as listed
// above, each as cheap as it can be and still the same IEEE operation:
// scale and bias are kept in shared memory as doubles, the int -> double
// conversion is the 2^52 + 2^31 trick, product and sum one double fma
// (the product is exact), and the requant rounds by adding 1.5 * 2^23, so
// that one conversion an output is left.  The stem is the same GEMM with
// one tap of K = KS (9 * cin padded to 32), its A tile gathered from the
// float32 observation and requantized on the way.
//
// What bounds it on the card: the operations, 2*B*H*W*9*C*C per block conv,
// over the dense int8 tensor-core rate (1979 TOP/s); the tile computes 256
// rows per 225 pixels at 15x15, its operands take 3/4 of shared memory's
// bandwidth at that rate, and the epilogues move the float32 skip track.
// One launch per conv leaves the activations in L2 between launches (an
// int8 activation is 9.5 MB at batch 256): a whole board's tower does not
// fit on chip (its int8 input, mid activation and float32 skip track alone
// take 204 KB at 15x15).
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// --fmad=false).  The entry point launches every conv on the stream it is
// given and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

// float(double(float(acc)) * scale + bias), scale and bias given in
// double.  float(acc) is acc itself below 2^24; the int -> double
// conversion is the exact 2^52 + 2^31 bias trick (an xor and a double
// add), and the product, exact in double, and the sum are one fma rounded
// once, as the separate multiply and add round: only the final conversion
// to float is left to the conversion unit.
__device__ __forceinline__ float dequant(int acc, double scale,
                                         double bias) {
  if (acc >= (1 << 24) || acc <= -(1 << 24)) acc = (int)__int2float_rn(acc);
  const double a = __dsub_rn(
      __hiloint2double(0x43300000, acc ^ (int)0x80000000),
      4503601774854144.0);  // 2^52 + 2^31
  return __double2float_rn(__fma_rn(a, scale, bias));
}

// clamp(rint(x * inv), -127, 127), rint rounding half to even: x * inv
// clamped to [-128, 128] (finite x: the ReLU's output or an observation),
// rounded by adding 1.5 * 2^23, whose float has an ulp of 1, and read back
// from the sum's bits.
__device__ __forceinline__ int8_t requant(float x, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(x, inv), -128.f), 128.f);
  const int q = __float_as_int(__fadd_rn(v, 12582912.f)) - 0x4B400000;
  return (int8_t)min(max(q, -127), 127);
}

// The int8 tower's element types, stem conversion and epilogue values:
//   STEM       : h = relu(dq(acc));        skip = h; out = rq(h, inv_out)
//   CONV1      : m = relu(dq(acc));        out = rq(m, inv_out)
//   CONV2      : h = relu(dq(acc) + skip); skip = h; out = rq(h, inv_out)
//   CONV2_LAST : h = relu(dq(acc) + skip); skip = h
// skip is read and written by the same thread, element by element.  The
// per-channel scale and bias sit in shared memory as doubles, the requant
// reciprocal as a float: NS scales, NS biases, then NS floats.
struct Int8Op {
  using Elem = int8_t;
  using Acc = int;
  struct Cols {
    double2 scale, bias;
    float2 inv;
  };

  static __device__ __forceinline__ int8_t stem_value(float x, int ci,
                                                      const ConvArgs& a) {
    return requant(x, a.inv_obs[ci]);
  }

  static __device__ __forceinline__ void load_params(const EpiArgs& e, int n0,
                                                     int ns, uint8_t* p) {
    double* d = reinterpret_cast<double*>(p);
    float* inv = reinterpret_cast<float*>(d + 2 * ns);
    for (int c = threadIdx.x; c < ns; c += THREADS) {
      d[c] = (double)e.scale[n0 + c];
      d[ns + c] = (double)e.bias[n0 + c];
      inv[c] = e.inv_out != nullptr ? e.inv_out[n0 + c] : 0.f;
    }
  }

  template <int NS>
  static __device__ __forceinline__ Cols cols(const uint8_t* p, int cl) {
    const double* d = reinterpret_cast<const double*>(p);
    return Cols{*reinterpret_cast<const double2*>(d + cl),
                *reinterpret_cast<const double2*>(d + NS + cl),
                *reinterpret_cast<const float2*>(
                    reinterpret_cast<const float*>(d + 2 * NS) + cl)};
  }

  // h = relu(dq(acc) (+ skip)) for a column pair
  template <int MODE>
  static __device__ __forceinline__ float2 value(const Cols& cp, int a0,
                                                 int a1, float2 s) {
    float h0 = dequant(a0, cp.scale.x, cp.bias.x);
    float h1 = dequant(a1, cp.scale.y, cp.bias.y);
    if constexpr (MODE == CONV2 || MODE == CONV2_LAST) {
      h0 = __fadd_rn(h0, s.x);
      h1 = __fadd_rn(h1, s.y);
    }
    return make_float2(fmaxf(h0, 0.f), fmaxf(h1, 0.f));
  }

  // the pair requantized, two bytes in the low half
  static __device__ __forceinline__ uint32_t pack(const Cols& cp, float2 h) {
    return (uint32_t)(uint8_t)requant(h.x, cp.inv.x) |
           ((uint32_t)(uint8_t)requant(h.y, cp.inv.y) << 8);
  }
};

constexpr int MW = 1;  // tiles of 64 rows (conv_tile.cuh)

template <int C>
int launch_tower(const float* obs, const Geometry& geo, int cin,
                 int n_blocks, int ks, const int8_t* stem_w,
                 const float* stem_scale, const float* stem_b,
                 const float* inv_obs, const float* inv_first,
                 const int8_t* block_w, const float* block_scale,
                 const float* block_b, const float* inv_mid,
                 const float* inv_next, int8_t* act_q, int8_t* mid_q,
                 float* out, cudaStream_t s) {
  ConvArgs a{};
  a.geo = geo;
  a.n_slices = 1;
  a.obs = obs;
  a.inv_obs = inv_obs;
  a.cin = cin;
  a.ks = ks;
  a.w = reinterpret_cast<const uint8_t*>(stem_w);
  a.kc = ks / 16;
  uint8_t* act = reinterpret_cast<uint8_t*>(act_q);
  uint8_t* mid = reinterpret_cast<uint8_t*>(mid_q);
  EpiArgs e{stem_scale, stem_b, inv_first, out, act, C, geo.rows_total};
  int err = launch_stem<Int8Op, C, MW>(a, e, s);
  if (err != 0) return err;

  a.kc = C / 16;
  const size_t wsize = (size_t)C * 9 * C;
  for (int i = 0; i < n_blocks; ++i) {
    a.act = act;
    a.w = reinterpret_cast<const uint8_t*>(block_w + (2 * i) * wsize);
    e = EpiArgs{block_scale + (2 * i) * C, block_b + (2 * i) * C,
                inv_mid + i * C, nullptr, mid, C, geo.rows_total};
    err = launch_conv<Int8Op, C, CONV1, C / 16, MW>(a, e, s);
    if (err != 0) return err;
    a.act = mid;
    a.w = reinterpret_cast<const uint8_t*>(block_w + (2 * i + 1) * wsize);
    const float* s2 = block_scale + (2 * i + 1) * C;
    const float* b2 = block_b + (2 * i + 1) * C;
    if (i + 1 < n_blocks) {
      e = EpiArgs{s2, b2, inv_next + i * C, out, act, C, geo.rows_total};
      err = launch_conv<Int8Op, C, CONV2, C / 16, MW>(a, e, s);
    } else {
      e = EpiArgs{s2, b2, nullptr, out, nullptr, C, geo.rows_total};
      err = launch_conv<Int8Op, C, CONV2_LAST, C / 16, MW>(a, e, s);
    }
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The tower on square boards of side `size`: out <- stem(obs) with act_q <-
// its requant, then per block mid_q <- rq(relu(conv1(act_q))), out <-
// relu(conv2(mid_q) + out) with act_q <- its requant (not after the last
// block).  The result is left in out (NHWC float32).  act_q and mid_q are
// zeroed chunk planes of rows_total rows (conv_tile::geometry).  Returns 0,
// or the CUDA error of the first launch that failed; a C other than 32, 64
// or 128, a KS that is not a multiple of 32 below 9 * cin or above 128, a
// rows_total
// that is not the geometry's, or a board too large for shared memory
// returns cudaErrorInvalidValue.
extern "C" int int8_tower_launch(
    const float* obs, int batch, int size, int cin, int c, int n_blocks,
    int ks, const int8_t* stem_w, const float* stem_scale,
    const float* stem_b, const float* inv_obs, const float* inv_first,
    const int8_t* block_w, const float* block_scale, const float* block_b,
    const float* inv_mid, const float* inv_next, int8_t* act_q,
    int8_t* mid_q, int rows_total, float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Geometry geo = geometry(batch, size, 64 * MW);
  if (ks % 32 != 0 || ks < 9 * cin || ks > 128 || batch < 1 ||
      rows_total != geo.rows_total)
    return (int)cudaErrorInvalidValue;
#define INT8_TOWER_ARGS                                                    \
  obs, geo, cin, n_blocks, ks, stem_w, stem_scale, stem_b, inv_obs,        \
      inv_first, block_w, block_scale, block_b, inv_mid, inv_next, act_q, \
      mid_q, out, s
  if (c == 128) return launch_tower<128>(INT8_TOWER_ARGS);
  if (c == 64) return launch_tower<64>(INT8_TOWER_ARGS);
  if (c == 32) return launch_tower<32>(INT8_TOWER_ARGS);
#undef INT8_TOWER_ARGS
  return (int)cudaErrorInvalidValue;
}
