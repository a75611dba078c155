// KataGo's elementwise passes for Hopper (sm_90a), one launch a pass:
//   s' = s + b              (a residual tensor b, rounded to bf16; optional)
//   store s' into s         (only where the sum is read again; optional)
//   u  = relu(s' * a + c)   (a, c float32 per channel, rounded once to bf16)
// or, for an inner block's first conv, u = relu(s + bias) with a bf16 bias
// per channel.
//
// It replaces no TPU kernel: the JAX package has no KataGo net.  In
// PyTorch a norm-and-ReLU is an addcmul of a bf16 tensor by float32
// vectors (a non-vectorized mixed-dtype pass) and a relu_, a residual add
// one more pass, a conv's bias a broadcast add_: 15 passes an ordinary block
// of models/nbt.py's bf16 forward, 885 MB at 256 boards of 15x15, where the
// work needs 6 passes and 463 MB.  Each pass here reads s (and b) once and
// writes u (and s') once.  The passes are far below the card's ridge, so
// the design serves the bytes alone:
//   - a thread owns a fixed group of eight channels (one 16-byte load or
//     store a point), so its eight scales and shifts are loaded once, into
//     registers;
//   - a grid-stride loop over points, two points a turn, every load of a
//     turn issued before any arithmetic, so that two 16-byte loads a
//     thread (four with a residual) are in flight; four or eight points a
//     turn were slower on the card (a trunk norm 45.5 and 44.1 us against
//     34.5), their registers cutting the blocks an SM holds;
//   - no shared memory, no allocation: the caller gives u.
//
// The arithmetic is PyTorch's, in its order, so that the pass equals the
// composition it replaces bit for bit (ops/katago_eltwise.py
// eltwise_plain):
//   - the sum in float32, rounded to bf16 (torch's bf16 add_);
//   - the affine on that bf16 value in float32 as one fused multiply-add,
//     as torch's addcmul computes it on the card (its float32 results equal
//     fmaf's, not a multiply and an add rounded apart);
//   - one rounding to bf16, then the ReLU (torch's relu_ on the bf16 value:
//     a negative value or -0 becomes +0, a NaN stays).
//
// Built by ops/_build.py as a shared library with a plain C interface.  s,
// b and u are [B, C, H, W] views whose channels are contiguous and whose
// points are one stride apart (channels_last, or a channel slice of one);
// C and the point strides are multiples of 8 and the bases 16-byte aligned,
// which the wrapper checks.  u may be s itself when the sum is not stored.
// The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int VEC = 8;             // bf16 channels a 16-byte load
constexpr int UNROLL = 2;          // points a thread loads before computing
constexpr int MAX_DEVICES = 64;

struct alignas(16) Bf16x8 {
  __nv_bfloat162 h[4];
};

__device__ __forceinline__ __nv_bfloat16 relu_bf16(__nv_bfloat16 v) {
  const float f = __bfloat162float(v);
  return f > 0.f || f != f ? v : __float2bfloat16_rn(0.f);
}

// ADD: s' = s + b for a tensor b; STORE: s' written back into s; BIAS: u =
// relu(s + bias), a bf16 bias a channel, in place of the affine
template <bool ADD, bool STORE, bool BIAS>
__global__ void __launch_bounds__(MAX_THREADS) kata_eltwise_kernel(
    __nv_bfloat16* s, long long s_pix, const __nv_bfloat16* __restrict__ b,
    long long b_pix, const float* __restrict__ scale,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* u, long long u_pix, int lanes, long long points) {
  const int groups = blockDim.x / lanes;
  const int c = VEC * (threadIdx.x % lanes);
  float a[VEC], t[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a[k] = BIAS ? 1.f : scale[c + k];
    t[k] = BIAS ? __bfloat162float(bias[c + k]) : shift[c + k];
  }
  const long long step = static_cast<long long>(gridDim.x) * groups;
  for (long long p = static_cast<long long>(blockIdx.x) * groups +
                     threadIdx.x / lanes;
       p < points; p += UNROLL * step) {
    Bf16x8 v[UNROLL], w[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const long long q = p + i * step;
      if (q < points) {
        v[i] = *reinterpret_cast<const Bf16x8*>(s + q * s_pix + c);
        if (ADD) w[i] = *reinterpret_cast<const Bf16x8*>(b + q * b_pix + c);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const long long q = p + i * step;
      if (q >= points) break;
      Bf16x8 out;
#pragma unroll
      for (int h = 0; h < VEC / 2; ++h) {
        __nv_bfloat162 sum = v[i].h[h];
        if (ADD) {
          sum = __floats2bfloat162_rn(
              __fadd_rn(__low2float(sum), __low2float(w[i].h[h])),
              __fadd_rn(__high2float(sum), __high2float(w[i].h[h])));
          v[i].h[h] = sum;
        }
        float y0, y1;
        if (BIAS) {
          y0 = __fadd_rn(__low2float(sum), t[2 * h]);
          y1 = __fadd_rn(__high2float(sum), t[2 * h + 1]);
        } else {
          y0 = __fmaf_rn(__low2float(sum), a[2 * h], t[2 * h]);
          y1 = __fmaf_rn(__high2float(sum), a[2 * h + 1], t[2 * h + 1]);
        }
        out.h[h] = __halves2bfloat162(relu_bf16(__float2bfloat16_rn(y0)),
                                      relu_bf16(__float2bfloat16_rn(y1)));
      }
      if (STORE) *reinterpret_cast<Bf16x8*>(s + q * s_pix + c) = v[i];
      *reinterpret_cast<Bf16x8*>(u + q * u_pix + c) = out;
    }
  }
}

// blocks an SM holds of a mode at a block size, by the occupancy API, read
// once a device
template <bool ADD, bool STORE, bool BIAS>
int blocks_on_card(int threads) {
  static int sms[MAX_DEVICES][MAX_THREADS / VEC + 1];
  static int per_sm[MAX_DEVICES][MAX_THREADS / VEC + 1];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) dev = MAX_DEVICES - 1;
  const int slot = threads / VEC;
  if (sms[dev][slot] == 0) {
    cudaDeviceGetAttribute(&sms[dev][slot], cudaDevAttrMultiProcessorCount,
                           dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev][slot], kata_eltwise_kernel<ADD, STORE, BIAS>, threads,
        0);
    if (per_sm[dev][slot] < 1) per_sm[dev][slot] = 1;
  }
  return sms[dev][slot] * per_sm[dev][slot];
}

template <bool ADD, bool STORE, bool BIAS>
void launch(__nv_bfloat16* s, long long s_pix, const __nv_bfloat16* b,
            long long b_pix, const float* scale, const float* shift,
            const __nv_bfloat16* bias, __nv_bfloat16* u, long long u_pix,
            int channels, long long points, cudaStream_t stream) {
  const int lanes = channels / VEC;
  const int groups = MAX_THREADS / lanes;
  const int threads = groups * lanes;
  const long long needed = (points + groups * UNROLL - 1) /
                           (static_cast<long long>(groups) * UNROLL);
  const long long most = blocks_on_card<ADD, STORE, BIAS>(threads);
  const int grid = static_cast<int>(needed < most ? needed : most);
  if (grid == 0) return;
  kata_eltwise_kernel<ADD, STORE, BIAS><<<grid, threads, 0, stream>>>(
      s, s_pix, b, b_pix, scale, shift, bias, u, u_pix, lanes, points);
}

}  // namespace

extern "C" int kata_eltwise_launch(void* s, long long s_pix, const void* b,
                                   long long b_pix, int store,
                                   const float* scale, const float* shift,
                                   const void* bias, void* u, long long u_pix,
                                   int channels, long long points,
                                   cudaStream_t stream) {
  auto* sp = static_cast<__nv_bfloat16*>(s);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  const auto* biasp = static_cast<const __nv_bfloat16*>(bias);
  auto* up = static_cast<__nv_bfloat16*>(u);
  if (bias != nullptr) {
    launch<false, false, true>(sp, s_pix, nullptr, 0, nullptr, nullptr, biasp,
                               up, u_pix, channels, points, stream);
  } else if (b == nullptr) {
    launch<false, false, false>(sp, s_pix, nullptr, 0, scale, shift, nullptr,
                                up, u_pix, channels, points, stream);
  } else if (store) {
    launch<true, true, false>(sp, s_pix, bp, b_pix, scale, shift, nullptr, up,
                              u_pix, channels, points, stream);
  } else {
    launch<true, false, false>(sp, s_pix, bp, b_pix, scale, shift, nullptr,
                               up, u_pix, channels, points, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
