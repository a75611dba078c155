// KataGo's global pooling for Hopper (sm_90a), one launch a pooling:
//   kata_gpool_kernel<false>  KataGPool: r += W^T [mean, mean * f1, max] of
//                             relu(g * scale + shift), broadcast over the
//                             board, in place (a trunk gpool block, the
//                             policy head)
//   kata_gpool_kernel<true>   the value head's pooling: [mean, mean * f1,
//                             mean * f2] of relu(g * scale + shift), float32
//
// It replaces no TPU kernel: the JAX package has no KataGo net.  In
// PyTorch each pooling is a norm, a ReLU, a mean, a max, a scale, a concat,
// a small matmul and a broadcast add, eight or more launches over tensors
// of a few MB, where the work is one read of g and one read and write of
// r: at 256 boards of 15x15 a trunk pooling moves 37 MB, 11 us at 3.35
// TB/s.  So the whole pooling is one launch, one block a board, and every
// loop keeps several loads in flight (a loop of one dependent load a turn
// waits out the memory's latency each turn: 45 us a trunk pooling, where
// this design takes a fraction of it):
//   1. each thread takes eight channels (one 16-byte load a point) and
//      every (256 / (C / 8))-th point, applies the affine and the ReLU, and
//      keeps a sum and a max in registers; the groups meet in shared
//      memory, in group order;
//   2. the float32 pooled vector times the bf16 weights [3C, cout] with
//      float32 sums, the threads splitting the 3C rows in contiguous
//      parts, added in part order;
//   3. every point's cout channels of r read eight at a time, the vector
//      added in float32, each rounded to bf16 once, written back.
// The value head's mode stops after 1 and writes the three float32 groups.
// The affine is a float32 multiply and an add rounded apart, as the plain
// version (ops/katago_gpool.py) computes it; the sums' order differs from
// torch's, so the card's test holds the kernel to the plain version within
// a tolerance.
//
// Built by ops/_build.py as a shared library with a plain C interface.
// g and r are [B, C, H, W] views whose channels are contiguous and whose
// points are one stride apart (channels_last, or a channel slice of a
// channels_last tensor); C, cout and the strides are multiples of 8 and the
// bases 16-byte aligned, which the wrapper checks.  The entry point
// launches on the stream it is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;             // bf16 channels a 16-byte load

struct alignas(16) Bf16x8 {
  __nv_bfloat162 h[4];
};

template <bool VALUE>
__global__ void __launch_bounds__(THREADS) kata_gpool_kernel(
    const __nv_bfloat16* __restrict__ g, long long g_board, long long g_pix,
    int channels, const float* __restrict__ scale,
    const float* __restrict__ shift, int cells, float f1, float f2,
    const __nv_bfloat16* __restrict__ w, int cout, __nv_bfloat16* r,
    long long r_board, long long r_pix, float* __restrict__ pooled_out) {
  extern __shared__ float smem[];
  const int lanes = channels / VEC;                // threads a point
  const int groups = THREADS / lanes;
  float* sums = smem;                              // [groups][channels]
  float* maxs = sums + groups * channels;          // [groups][channels]
  float* pooled = maxs + groups * channels;        // [3 * channels]
  float* parts = pooled + 3 * channels;            // [n_parts][cout]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // 1. affine, ReLU, sum and max over the board
  if (tid < groups * lanes) {
    const int c = VEC * (tid % lanes);
    const int grp = tid / lanes;
    float s[VEC], t[VEC], acc[VEC], mx[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] = scale[c + k];
      t[k] = shift[c + k];
      acc[k] = 0.f;
      mx[k] = 0.f;
    }
    const __nv_bfloat16* gb = g + b * g_board + c;
#pragma unroll 4
    for (int p = grp; p < cells; p += groups) {
      const Bf16x8 v = *reinterpret_cast<const Bf16x8*>(gb + p * g_pix);
#pragma unroll
      for (int k = 0; k < VEC / 2; ++k) {
        const float x0 = fmaxf(
            __fadd_rn(__fmul_rn(__low2float(v.h[k]), s[2 * k]), t[2 * k]),
            0.f);
        const float x1 = fmaxf(__fadd_rn(__fmul_rn(__high2float(v.h[k]),
                                                   s[2 * k + 1]),
                                         t[2 * k + 1]),
                               0.f);
        acc[2 * k] += x0;
        acc[2 * k + 1] += x1;
        mx[2 * k] = fmaxf(mx[2 * k], x0);
        mx[2 * k + 1] = fmaxf(mx[2 * k + 1], x1);
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sums[grp * channels + c + k] = acc[k];
      maxs[grp * channels + c + k] = mx[k];
    }
  }
  __syncthreads();
  for (int c = tid; c < channels; c += THREADS) {
    float s = 0.f, m = 0.f;
    for (int k = 0; k < groups; ++k) {
      s += sums[k * channels + c];
      m = fmaxf(m, maxs[k * channels + c]);
    }
    const float mean = s / static_cast<float>(cells);
    if (VALUE) {
      float* out = pooled_out + static_cast<long long>(b) * 3 * channels;
      out[c] = mean;
      out[channels + c] = mean * f1;
      out[2 * channels + c] = mean * f2;
    } else {
      pooled[c] = mean;
      pooled[channels + c] = mean * f1;
      pooled[2 * channels + c] = m;
    }
  }
  if (VALUE) return;
  __syncthreads();

  // 2. the linear, rows split in contiguous parts
  const int rows = 3 * channels;
  const int n_parts = cout < THREADS ? THREADS / cout : 1;
  const int per_part = (rows + n_parts - 1) / n_parts;
  for (int k = tid; k < n_parts * cout; k += THREADS) {
    const int j = k % cout;
    const int part = k / cout;
    const int i0 = part * per_part;
    const int i1 = min(rows, i0 + per_part);
    float acc = 0.f;
#pragma unroll 8
    for (int i = i0; i < i1; ++i) {
      acc = fmaf(pooled[i], __bfloat162float(w[i * cout + j]), acc);
    }
    parts[part * cout + j] = acc;
  }
  __syncthreads();
  for (int j = tid; j < cout; j += THREADS) {
    float acc = parts[j];
    for (int part = 1; part < n_parts; ++part) acc += parts[part * cout + j];
    parts[j] = acc;
  }
  __syncthreads();

  // 3. add over the board, in place
  __nv_bfloat16* rb = r + b * r_board;
  const int octets = cout / VEC;
#pragma unroll 4
  for (int k = tid; k < cells * octets; k += THREADS) {
    const int p = k / octets;
    const int j = VEC * (k % octets);
    Bf16x8* q = reinterpret_cast<Bf16x8*>(rb + p * r_pix + j);
    Bf16x8 v = *q;
#pragma unroll
    for (int h = 0; h < VEC / 2; ++h) {
      v.h[h] = __floats2bfloat162_rn(__low2float(v.h[h]) + parts[j + 2 * h],
                                     __high2float(v.h[h]) +
                                         parts[j + 2 * h + 1]);
    }
    *q = v;
  }
}

}  // namespace

extern "C" int kata_gpool_launch(const void* g, long long g_board,
                                 long long g_pix, int channels,
                                 const float* scale, const float* shift,
                                 int cells, float f1, float f2, const void* w,
                                 int cout, void* r, long long r_board,
                                 long long r_pix, float* pooled, int batch,
                                 cudaStream_t stream) {
  const int groups = THREADS / (channels / VEC);
  const bool value = w == nullptr;
  const int n_parts = value ? 0 : (cout < THREADS ? THREADS / cout : 1);
  const size_t smem = sizeof(float) *
      (2 * groups * channels + 3 * channels + n_parts * cout);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  if (value) {
    kata_gpool_kernel<true><<<batch, THREADS, smem, stream>>>(
        gp, g_board, g_pix, channels, scale, shift, cells, f1, f2, nullptr, 0,
        nullptr, 0, 0, pooled);
  } else {
    kata_gpool_kernel<false><<<batch, THREADS, smem, stream>>>(
        gp, g_board, g_pix, channels, scale, shift, cells, f1, f2,
        static_cast<const __nv_bfloat16*>(w), cout,
        static_cast<__nv_bfloat16*>(r), r_board, r_pix, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
