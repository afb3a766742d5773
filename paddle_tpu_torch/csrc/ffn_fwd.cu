// Fused transformer FFN forward for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces paddle_tpu/ops/pallas/ffn.py::_fwd_kernel (launched by
// _ffn_forward).  It computes the same function:
//
//   pre = x @ W1[:, f-tile] + b1                (f32)
//   h   = act(pre)   act in {gelu (Abramowitz-Stegun erf), gelu_tanh, relu}
//   h   = keep(seed, t, f) ? h / (1 - p) : 0    (_ffn_keep hash)
//   acc += bf16(h) @ W2[f-tile, :]              (f32)
//   out = bf16(acc + b2)
//
// x (T, H), W1 (H, F), b1 (F), W2 (F, H), b2 (H), out (T, H), all bf16 and
// contiguous.  The (T, F) hidden activation never reaches device memory.
//
// Design: one CTA of 8 warps per 32-token tile, looping over 64-wide d_ff
// tiles.  The hard part is the f32 output accumulator: the TPU keeps a
// (512, 768) f32 block in VMEM (1.5 MB); an SM has 227 KB of shared memory.
// Here the accumulator is spread over the registers of the CTA's 8 warps:
// a 32-token tile is 32 x 768 f32 = 96 KB, i.e. each warp holds 32 x 96 as
// 2 x 6 WMMA fragments (96 registers a thread).  That fixes the small token
// tile (64 tokens would need ~190 accumulator registers a thread) and
// avoids splitting H across CTAs, which would recompute x @ W1 once per
// H slice.  Shared memory holds the x tile (loaded once), one weight slab
// (W1[:, f-tile], then W2[f-tile, :] in the same buffer), and the hidden
// tile in f32 and bf16: ~170 KB at H=768, one CTA per SM.
//
// Bound on the H100: at BERT-base shapes (H=768, F=3072, T=B*512) the work
// is 4*T*H*F flops against (2*T*H + 2*H*F)*2 bytes: ~1500 flop/byte at
// T=16384, far above the bf16 ridge (~295) — compute-bound.  This simple
// kernel re-reads both weight matrices from L2 once per token tile, runs
// WMMA (not wgmma) and does not overlap loads with math; it is far from the
// tensor-core roof.  Making it fast is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 32;  // token rows per CTA
constexpr int BF = 64;  // d_ff columns per inner step
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

enum { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_RELU = 2 };

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

template <int H>
struct Layout {
  static constexpr int LDX = H + 8;    // bf16 x tile
  static constexpr int LDW1 = BF + 8;  // bf16 W1 slab (H rows)
  static constexpr int LDW2 = H + 8;   // bf16 W2 slab (BF rows)
  static constexpr int LDHF = BF + 4;  // f32 pre-activation tile
  static constexpr int LDHB = BF + 8;  // bf16 hidden tile
  static constexpr int LDOUT = H + 4;  // f32 output staging (in the slab)
  static constexpr size_t X = 0;
  static constexpr size_t SLAB = align128(X + (size_t)BT * LDX * 2);
  static constexpr size_t SLAB_BYTES =
      cmax(cmax((size_t)H * LDW1 * 2, (size_t)BF * LDW2 * 2),
           (size_t)BT * LDOUT * 4);
  static constexpr size_t HF = align128(SLAB + SLAB_BYTES);
  static constexpr size_t HB = align128(HF + (size_t)BT * LDHF * 4);
  static constexpr size_t BYTES = align128(HB + (size_t)BT * LDHB * 2);
};

// paddle_tpu/ops/pallas/ffn.py::_ffn_keep, bit for bit
__device__ __forceinline__ uint32_t keep_hash(uint32_t seed, uint32_t r,
                                              uint32_t c) {
  uint32_t x = (r * 0x9E3779B1u) ^ (c * 0x85EBCA77u);
  x ^= seed * 0x165667B1u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// paddle_tpu/ops/pallas/ffn.py::_erf (Abramowitz-Stegun 7.1.26)
__device__ __forceinline__ float as_erf(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float s = (float)((x > 0.f) - (x < 0.f));
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  return s * (1.0f - poly * expf(-ax * ax));
}

template <int ACT>
__device__ __forceinline__ float act(float h) {
  if (ACT == ACT_GELU) return h * 0.5f * (1.0f + as_erf(h * 0.7071067811865476f));
  if (ACT == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return h * (0.5f * (1.0f + tanhf(c * (h + 0.044715f * (h * h * h)))));
  }
  return fmaxf(h, 0.f);
}

template <int H, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ out, int T,
               int F, uint32_t drop_thresh, float keep_prob, uint32_t seed) {
  using LT = Layout<H>;
  constexpr int NF = H / 128;  // 16-wide output fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem + LT::X);
  bf16* slab = reinterpret_cast<bf16*>(smem + LT::SLAB);
  float* sHF = reinterpret_cast<float*>(smem + LT::HF);
  bf16* sHB = reinterpret_cast<bf16*>(smem + LT::HB);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int t0 = blockIdx.x * BT;
  const int rt = warp / 4, ct = warp % 4;  // phase-1 fragment of this warp
  const int col0 = warp * (H / 8);         // phase-2 output columns

  constexpr int XCH = H / 8;
  for (int i = tid; i < BT * XCH; i += THREADS) {
    const int r = i / XCH, c = i % XCH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T)
      val = *reinterpret_cast<const uint4*>(x + (long long)(t0 + r) * H + c * 8);
    *reinterpret_cast<uint4*>(sX + r * LT::LDX + c * 8) = val;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int f0 = 0; f0 < F; f0 += BF) {
    __syncthreads();  // the previous step is done with the slab and sHB
    constexpr int W1CH = BF / 8;
    for (int i = tid; i < H * W1CH; i += THREADS) {
      const int r = i / W1CH, c = i % W1CH;
      *reinterpret_cast<uint4*>(slab + r * LT::LDW1 + c * 8) =
          *reinterpret_cast<const uint4*>(w1 + (long long)r * F + f0 + c * 8);
    }
    __syncthreads();

    // phase 1: pre = x @ W1[:, f0:f0+BF], one 16x16 fragment per warp
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pre;
      wmma::fill_fragment(pre, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < H / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sX + rt * 16 * LT::LDX + kk * 16, LT::LDX);
        wmma::load_matrix_sync(fb, slab + kk * 16 * LT::LDW1 + ct * 16,
                               LT::LDW1);
        wmma::mma_sync(pre, fa, fb, pre);
      }
      wmma::store_matrix_sync(sHF + rt * 16 * LT::LDHF + ct * 16, pre,
                              LT::LDHF, wmma::mem_row_major);
    }
    __syncthreads();  // sHF complete; every warp is done reading W1

    // bias + activation + dropout, cast to bf16
    for (int i = tid; i < BT * BF; i += THREADS) {
      const int r = i / BF, c = i % BF;
      float hv = act<ACT>(sHF[r * LT::LDHF + c] + __bfloat162float(b1[f0 + c]));
      if (drop_thresh != 0u) {
        const bool keep = keep_hash(seed, (uint32_t)(t0 + r),
                                    (uint32_t)(f0 + c)) >= drop_thresh;
        hv = keep ? hv / keep_prob : 0.f;
      }
      sHB[r * LT::LDHB + c] = __float2bfloat16(hv);
    }
    constexpr int W2CH = H / 8;
    for (int i = tid; i < BF * W2CH; i += THREADS) {
      const int r = i / W2CH, c = i % W2CH;
      *reinterpret_cast<uint4*>(slab + r * LT::LDW2 + c * 8) =
          *reinterpret_cast<const uint4*>(w2 + (long long)(f0 + r) * H + c * 8);
    }
    __syncthreads();

    // phase 2: acc[:, warp's columns] += h @ W2[f0:f0+BF, columns]
#pragma unroll
    for (int kk = 0; kk < BF / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa0, fa1;
      wmma::load_matrix_sync(fa0, sHB + kk * 16, LT::LDHB);
      wmma::load_matrix_sync(fa1, sHB + 16 * LT::LDHB + kk * 16, LT::LDHB);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, slab + kk * 16 * LT::LDW2 + col0 + j * 16,
                               LT::LDW2);
        wmma::mma_sync(acc[0][j], fa0, fb, acc[0][j]);
        wmma::mma_sync(acc[1][j], fa1, fb, acc[1][j]);
      }
    }
  }
  __syncthreads();  // every warp is done with the slab: reuse it as f32

  float* sOut = reinterpret_cast<float*>(smem + LT::SLAB);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(sOut + col0 + j * 16, acc[0][j], LT::LDOUT,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sOut + 16 * LT::LDOUT + col0 + j * 16, acc[1][j],
                            LT::LDOUT, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < BT * H; i += THREADS) {
    const int r = i / H, c = i % H;
    if (t0 + r < T)
      out[(long long)(t0 + r) * H + c] =
          __float2bfloat16(sOut[r * LT::LDOUT + c] + __bfloat162float(b2[c]));
  }
}

template <int H, int ACT>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int T, int F,
                   uint32_t drop_thresh, float keep_prob, uint32_t seed,
                   cudaStream_t stream) {
  const size_t bytes = Layout<H>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel<H, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BT - 1) / BT);
  ffn_fwd_kernel<H, ACT><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), T, F,
      drop_thresh, keep_prob, seed);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_act(int act_id, const void* x, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* out, int T, int F, uint32_t drop_thresh,
                       float keep_prob, uint32_t seed, cudaStream_t s) {
  switch (act_id) {
    case ACT_GELU:
      return launch<H, ACT_GELU>(x, w1, b1, w2, b2, out, T, F, drop_thresh,
                                 keep_prob, seed, s);
    case ACT_GELU_TANH:
      return launch<H, ACT_GELU_TANH>(x, w1, b1, w2, b2, out, T, F,
                                      drop_thresh, keep_prob, seed, s);
    case ACT_RELU:
      return launch<H, ACT_RELU>(x, w1, b1, w2, b2, out, T, F, drop_thresh,
                                 keep_prob, seed, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// act_id: 0 gelu (A-S erf), 1 gelu_tanh, 2 relu
int ffn_fwd_bf16(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, int T, int H,
                 int F, int act_id, unsigned int drop_thresh,
                 float keep_prob, unsigned int seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 128:
      return launch_act<128>(act_id, x, w1, b1, w2, b2, out, T, F,
                             drop_thresh, keep_prob, seed, s);
    case 256:
      return launch_act<256>(act_id, x, w1, b1, w2, b2, out, T, F,
                             drop_thresh, keep_prob, seed, s);
    case 512:
      return launch_act<512>(act_id, x, w1, b1, w2, b2, out, T, F,
                             drop_thresh, keep_prob, seed, s);
    case 768:
      return launch_act<768>(act_id, x, w1, b1, w2, b2, out, T, F,
                             drop_thresh, keep_prob, seed, s);
    case 1024:
      return launch_act<1024>(act_id, x, w1, b1, w2, b2, out, T, F,
                              drop_thresh, keep_prob, seed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
