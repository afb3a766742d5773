// Fused transformer FFN backward for Hopper (sm_90a): bf16 in, f32
// accumulate.
//
// Replaces paddle_tpu/ops/pallas/ffn.py::_bwd_dw_kernel and ::_bwd_dx_kernel
// (launched by _ffn_backward).  Both recompute the hidden tile from x instead
// of reading it back (it was never stored):
//
//   pre  = x @ W1[:, f] + b1                         (f32)
//   h    = keep(seed, t, f) ? act(pre) / (1 - p) : 0  (_ffn_keep hash)
//   dh   = keep ? (g @ W2[f, :]^T) / (1 - p) : 0
//   dpre = dh * act'(pre)
//   dW kernel:  dW2[f, :] += bf16(h)^T g,  dW1[:, f] += x^T bf16(dpre),
//               db1[f] += sum_t dpre
//   dx kernel:  dx += bf16(dpre) @ W1[:, f]^T
//
// x, g (T, H), W1 (H, F), b1 (F), W2 (F, H), all bf16 and contiguous;
// dx (T, H), dW1 (H, F), db1 (F), dW2 (F, H) come out in bf16, the
// weights' dtype, as in JAX.  db2 = sum g is a torch reduction in the
// wrapper, as in JAX.
//
// dx design: the forward kernel's shape.  One 8-warp CTA per 32-token tile
// loops over 64-wide d_ff tiles; the (32, H) f32 accumulator is spread over
// the warps' registers (2 x H/128 WMMA fragments a warp).  Per tile the
// W2 slab comes in first (dh), then the W1 slab into the same buffer (pre,
// then the dx product).  Shared memory holds the x and g tiles side by
// side (2 x 49 KB at H=768) plus one slab (110 KB), which is why the
// backward stops at H=768.  pre and dh of one 16x16 fragment are owned by
// the same warp, and accumulator fragments of one type share one element
// order; a fragment loaded once from a table of element indices gives each
// thread the (row, column) of its elements, so bias, activation gradient
// and dropout are applied to dh in registers, and only bf16 dpre goes
// through shared memory.
//
// dW design (the hard part): the TPU held (H, 512) and (512, H) f32
// accumulators in VMEM (3 MB at H=768) over a sequential token axis.  On
// Hopper one CTA owning a 64-wide d_ff slice would need 2 x 768 x 64 x 4 =
// 393 KB, and 3072 / 64 = 48 CTAs would not fill 132 SMs.  Here a CTA owns a
// 16-wide d_ff slice and one of a few token splits: its dW1 (H, 16) and dW2
// (16, H) slices sit in the registers of its 8 warps (12 fragments a warp
// at H=768, 96 registers a thread) while it walks its split's 32-token
// tiles.  Per tile the two (32, 16) recompute products (pre, dh) are
// split over the 8 warps along H, summed through shared memory, and turned
// into bf16 h and dpre tiles; then every warp adds its H/8 columns of both
// weight gradients.  Each split writes f32 partials to a workspace and a
// second small kernel sums the splits in a fixed order and casts to bf16:
// no float atomics, so the result does not depend on scheduling.  At
// BERT-base shapes: 192 slices x 2 splits = 384 CTAs, and a 38 MB f32
// workspace written and read once.  The W1/W2 slices and the x/g tiles
// take ~173 KB of shared memory at H=768: one CTA an SM.
//
// Bound on the H100: at BERT-base shapes (T = 16384, H = 768, F = 3072) the
// dW pass does 4 and the dx pass 3 products of 2*T*H*F flops (309 and
// 232 GFLOP) against ~60 MB of operands: compute-bound, 0.313 and 0.234 ms
// at the bf16 tensor-core peak.  These simple kernels run WMMA (not wgmma),
// do not overlap loads with math, and the dx pass recomputes both
// products per tile; they are far from that bound.  Making them fast is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 32;   // token rows per tile (both kernels)
constexpr int BF = 64;   // dx kernel: d_ff columns per step
constexpr int BFW = 16;  // dW kernel: d_ff columns per CTA
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

enum { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_RELU = 2 };

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

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

// paddle_tpu/ops/pallas/ffn.py::_act_grad
template <int ACT>
__device__ __forceinline__ float act_grad(float h) {
  if (ACT == ACT_GELU) {
    const float cdf = 0.5f * (1.0f + as_erf(h * 0.7071067811865476f));
    const float pdf = 0.3989422804014327f * expf(-0.5f * h * h);
    return cdf + h * pdf;
  }
  if (ACT == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (h + 0.044715f * (h * h * h)));
    return 0.5f * (1.0f + t) +
           0.5f * h * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * h * h);
  }
  return h > 0.f ? 1.f : 0.f;
}

// BT rows of a (T, H) bf16 matrix into shared memory (row stride ld);
// rows past T are zero
template <int H>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          int t0, int T) {
  constexpr int CH = H / 8;
  for (int i = threadIdx.x; i < BT * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + (long long)(t0 + r) * H + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// ---- dx ----------------------------------------------------------------------

template <int H>
struct DxLayout {
  static constexpr int LDX = H + 8;    // bf16 x and g tiles
  static constexpr int LDW1 = BF + 8;  // bf16 W1 slab (H rows)
  static constexpr int LDW2 = H + 8;   // bf16 W2 slab (BF rows)
  static constexpr int LDDP = BF + 8;  // bf16 dpre tile
  static constexpr int LDOUT = H + 4;  // f32 output staging (in the slab)
  static constexpr size_t X = 0;
  static constexpr size_t G = align128(X + (size_t)BT * LDX * 2);
  static constexpr size_t SLAB = align128(G + (size_t)BT * LDX * 2);
  static constexpr size_t SLAB_BYTES =
      cmax(cmax((size_t)H * LDW1 * 2, (size_t)BF * LDW2 * 2),
           (size_t)BT * LDOUT * 4);
  static constexpr size_t DP = align128(SLAB + SLAB_BYTES);
  static constexpr size_t POS = align128(DP + (size_t)BT * LDDP * 2);
  static constexpr size_t BYTES = align128(POS + 256 * 4);
};

template <int H, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, bf16* __restrict__ dx, int T,
                  int F, uint32_t drop_thresh, float inv_keep, uint32_t seed) {
  using LT = DxLayout<H>;
  constexpr int NF = H / 128;  // 16-wide output fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem + LT::X);
  bf16* sG = reinterpret_cast<bf16*>(smem + LT::G);
  bf16* slab = reinterpret_cast<bf16*>(smem + LT::SLAB);
  bf16* sDP = reinterpret_cast<bf16*>(smem + LT::DP);
  float* sPos = reinterpret_cast<float*>(smem + LT::POS);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int t0 = blockIdx.x * BT;
  const int rt = warp / 4, ct = warp % 4;  // the (pre, dh) fragment
  const int col0 = warp * (H / 8);         // this warp's dx columns

  load_rows<H>(sX, LT::LDX, x, t0, T);
  load_rows<H>(sG, LT::LDX, g, t0, T);
  for (int i = tid; i < 256; i += THREADS) sPos[i] = (float)i;
  __syncthreads();
  // element i of any Acc fragment sits at row pos.x[i] / 16, column % 16
  Acc pos;
  wmma::load_matrix_sync(pos, sPos, 16, wmma::mem_row_major);

  Acc acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int f0 = 0; f0 < F; f0 += BF) {
    __syncthreads();  // the previous step is done with the slab and sDP
    constexpr int W2CH = H / 8;
    for (int i = tid; i < BF * W2CH; i += THREADS) {
      const int r = i / W2CH, c = i % W2CH;
      *reinterpret_cast<uint4*>(slab + r * LT::LDW2 + c * 8) =
          *reinterpret_cast<const uint4*>(w2 + (long long)(f0 + r) * H + c * 8);
    }
    __syncthreads();

    // dh = g @ W2[f-tile, :]^T, one 16x16 fragment per warp
    Acc dh;
    wmma::fill_fragment(dh, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < H / 16; ++kk) {
      ARow fa;
      BCol fb;
      wmma::load_matrix_sync(fa, sG + rt * 16 * LT::LDX + kk * 16, LT::LDX);
      wmma::load_matrix_sync(fb, slab + ct * 16 * LT::LDW2 + kk * 16, LT::LDW2);
      wmma::mma_sync(dh, fa, fb, dh);
    }
    __syncthreads();  // every warp is done reading W2

    constexpr int W1CH = BF / 8;
    for (int i = tid; i < H * W1CH; i += THREADS) {
      const int r = i / W1CH, c = i % W1CH;
      *reinterpret_cast<uint4*>(slab + r * LT::LDW1 + c * 8) =
          *reinterpret_cast<const uint4*>(w1 + (long long)r * F + f0 + c * 8);
    }
    __syncthreads();

    // pre = x @ W1[:, f-tile], the same fragment as dh
    Acc pre;
    wmma::fill_fragment(pre, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < H / 16; ++kk) {
      ARow fa;
      BRow fb;
      wmma::load_matrix_sync(fa, sX + rt * 16 * LT::LDX + kk * 16, LT::LDX);
      wmma::load_matrix_sync(fb, slab + kk * 16 * LT::LDW1 + ct * 16, LT::LDW1);
      wmma::mma_sync(pre, fa, fb, pre);
    }

    // dpre = drop'(dh) * act'(pre + b1), in registers, to bf16 sDP
#pragma unroll
    for (int i = 0; i < pre.num_elements; ++i) {
      const int e = (int)pos.x[i];
      const int r = rt * 16 + e / 16, c = ct * 16 + e % 16;
      const float pv = pre.x[i] + __bfloat162float(b1[f0 + c]);
      float d = dh.x[i];
      if (drop_thresh != 0u) {
        const bool keep = keep_hash(seed, (uint32_t)(t0 + r),
                                    (uint32_t)(f0 + c)) >= drop_thresh;
        d = keep ? d * inv_keep : 0.f;
      }
      sDP[r * LT::LDDP + c] = __float2bfloat16(d * act_grad<ACT>(pv));
    }
    __syncthreads();

    // acc[:, warp's columns] += dpre @ W1[warp's columns, f-tile]^T
#pragma unroll
    for (int kk = 0; kk < BF / 16; ++kk) {
      ARow fa0, fa1;
      wmma::load_matrix_sync(fa0, sDP + kk * 16, LT::LDDP);
      wmma::load_matrix_sync(fa1, sDP + 16 * LT::LDDP + kk * 16, LT::LDDP);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        BCol fb;
        wmma::load_matrix_sync(fb, slab + (col0 + j * 16) * LT::LDW1 + kk * 16,
                               LT::LDW1);
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
      dx[(long long)(t0 + r) * H + c] = __float2bfloat16(sOut[r * LT::LDOUT + c]);
  }
}

// ---- dW ----------------------------------------------------------------------

template <int H>
struct DwLayout {
  static constexpr int LDX = H + 8;     // bf16 x and g tiles
  static constexpr int LDW1 = BFW + 8;  // bf16 W1 slice (H rows)
  static constexpr int LDW2 = H + 8;    // bf16 W2 slice (BFW rows)
  static constexpr int LDT = BFW + 8;   // bf16 h and dpre tiles (BT rows)
  static constexpr size_t X = 0;
  static constexpr size_t G = align128(X + (size_t)BT * LDX * 2);
  static constexpr size_t W1 = align128(G + (size_t)BT * LDX * 2);
  static constexpr size_t W2 = align128(W1 + (size_t)H * LDW1 * 2);
  static constexpr size_t PART = align128(W2 + (size_t)BFW * LDW2 * 2);
  static constexpr size_t HT = align128(PART + (size_t)WARPS * 256 * 4);
  static constexpr size_t DPT = align128(HT + (size_t)BT * LDT * 2);
  static constexpr size_t DB1 = align128(DPT + (size_t)BT * LDT * 2);
  static constexpr size_t BYTES = align128(DB1 + (size_t)THREADS * 4);
};

// grid (F / BFW, n_split); split s sums token tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) into its own workspace
// row ws[s] = [dW1 (H, F) | dW2 (F, H) | db1 (F)] in f32
template <int H, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, float* __restrict__ ws, int T,
                  int F, int tiles_per_split, uint32_t drop_thresh,
                  float inv_keep, uint32_t seed) {
  using LT = DwLayout<H>;
  constexpr int NJ = H / 128;  // 16-wide fragments per warp, each of dW1/dW2
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem + LT::X);
  bf16* sG = reinterpret_cast<bf16*>(smem + LT::G);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + LT::W1);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + LT::W2);
  float* sPart = reinterpret_cast<float*>(smem + LT::PART);
  bf16* sHT = reinterpret_cast<bf16*>(smem + LT::HT);
  bf16* sDPT = reinterpret_cast<bf16*>(smem + LT::DPT);
  float* sDB1 = reinterpret_cast<float*>(smem + LT::DB1);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int f0 = blockIdx.x * BFW;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split * BT;
  const int t_end = min(T, t_begin + tiles_per_split * BT);
  // recompute job of this warp: pre (kind 0) or dh (kind 1), row tile prt,
  // half khalf of the contraction over H
  const int kind = warp / 4, prt = (warp / 2) % 2, khalf = warp % 2;
  const int hc0 = warp * (H / 8);  // this warp's H columns of dW1^T / dW2

  for (int i = tid; i < H * (BFW / 8); i += THREADS) {
    const int r = i / (BFW / 8), c = i % (BFW / 8);
    *reinterpret_cast<uint4*>(sW1 + r * LT::LDW1 + c * 8) =
        *reinterpret_cast<const uint4*>(w1 + (long long)r * F + f0 + c * 8);
  }
  for (int i = tid; i < BFW * (H / 8); i += THREADS) {
    const int r = i / (H / 8), c = i % (H / 8);
    *reinterpret_cast<uint4*>(sW2 + r * LT::LDW2 + c * 8) =
        *reinterpret_cast<const uint4*>(w2 + (long long)(f0 + r) * H + c * 8);
  }

  Acc acc_w1[NJ], acc_w2[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::fill_fragment(acc_w1[j], 0.f);
    wmma::fill_fragment(acc_w2[j], 0.f);
  }
  float db1_acc = 0.f;  // column tid % 16 of the rows this thread visits

  for (int t0 = t_begin; t0 < t_end; t0 += BT) {
    __syncthreads();  // the previous tile is done with sX/sG/sHT/sDPT
    load_rows<H>(sX, LT::LDX, x, t0, T);
    load_rows<H>(sG, LT::LDX, g, t0, T);
    __syncthreads();

    // pre = x @ W1[:, slice] or dh = g @ W2[slice, :]^T: half of one
    // 16x16 fragment per warp
    {
      Acc part;
      wmma::fill_fragment(part, 0.f);
      const bf16* a = (kind == 0 ? sX : sG) + prt * 16 * LT::LDX;
      for (int kk = khalf * (H / 32); kk < (khalf + 1) * (H / 32); ++kk) {
        ARow fa;
        wmma::load_matrix_sync(fa, a + kk * 16, LT::LDX);
        if (kind == 0) {
          BRow fb;
          wmma::load_matrix_sync(fb, sW1 + kk * 16 * LT::LDW1, LT::LDW1);
          wmma::mma_sync(part, fa, fb, part);
        } else {
          BCol fb;
          wmma::load_matrix_sync(fb, sW2 + kk * 16, LT::LDW2);
          wmma::mma_sync(part, fa, fb, part);
        }
      }
      wmma::store_matrix_sync(sPart + warp * 256, part, 16,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // bias, activation, dropout, act': the (BT, BFW) h and dpre tiles
    for (int e = tid; e < BT * BFW; e += THREADS) {
      const int r = e / BFW, c = e % BFW;
      const int o = (r / 16) * 2 * 256 + (r % 16) * 16 + c;
      const float pv = sPart[o] + sPart[o + 256] +
                       __bfloat162float(b1[f0 + c]);
      float d = sPart[4 * 256 + o] + sPart[5 * 256 + o];
      float hv = act<ACT>(pv);
      if (drop_thresh != 0u) {
        const bool keep = keep_hash(seed, (uint32_t)(t0 + r),
                                    (uint32_t)(f0 + c)) >= drop_thresh;
        hv = keep ? hv * inv_keep : 0.f;
        d = keep ? d * inv_keep : 0.f;
      }
      const float dpre = d * act_grad<ACT>(pv);
      db1_acc += dpre;  // rows past T have g = 0, so dpre = 0
      sHT[r * LT::LDT + c] = __float2bfloat16(hv);
      sDPT[r * LT::LDT + c] = __float2bfloat16(dpre);
    }
    __syncthreads();

    // dW2[slice, warp's H] += h^T g;  dW1[warp's H, slice] += x^T dpre
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      ACol fh;
      BRow fdp;
      wmma::load_matrix_sync(fh, sHT + kk * 16 * LT::LDT, LT::LDT);
      wmma::load_matrix_sync(fdp, sDPT + kk * 16 * LT::LDT, LT::LDT);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int hc = hc0 + j * 16;
        BRow fg;
        wmma::load_matrix_sync(fg, sG + kk * 16 * LT::LDX + hc, LT::LDX);
        wmma::mma_sync(acc_w2[j], fh, fg, acc_w2[j]);
        ACol fx;
        wmma::load_matrix_sync(fx, sX + kk * 16 * LT::LDX + hc, LT::LDX);
        wmma::mma_sync(acc_w1[j], fx, fdp, acc_w1[j]);
      }
    }
  }

  // this split's f32 partials, straight from the fragments
  const long long HF = (long long)H * F;
  float* wd1 = ws + (long long)split * (2 * HF + F);
  float* wd2 = wd1 + HF;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int hc = hc0 + j * 16;
    wmma::store_matrix_sync(wd1 + (long long)hc * F + f0, acc_w1[j], F,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(wd2 + (long long)f0 * H + hc, acc_w2[j], H,
                            wmma::mem_row_major);
  }
  sDB1[tid] = db1_acc;
  __syncthreads();
  if (tid < BFW) {
    float s = 0.f;
    for (int i = tid; i < THREADS; i += BFW) s += sDB1[i];
    wd1[2 * HF + f0 + tid] = s;
  }
}

// sum the splits' partials in split order and cast to bf16
__global__ void ffn_dw_reduce_kernel(const float* __restrict__ ws,
                                     int n_split, long long HF, int F,
                                     bf16* __restrict__ dw1,
                                     bf16* __restrict__ dw2,
                                     bf16* __restrict__ db1) {
  const long long n = 2 * HF + F;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < n_split; ++sp) s += ws[sp * n + i];
    const bf16 v = __float2bfloat16(s);
    if (i < HF)
      dw1[i] = v;
    else if (i < 2 * HF)
      dw2[i - HF] = v;
    else
      db1[i - 2 * HF] = v;
  }
}

struct Args {
  const bf16 *x, *g, *w1, *b1, *w2;
  int T, F;
  uint32_t drop_thresh;
  float inv_keep;
  uint32_t seed;
  cudaStream_t stream;
};

template <int H, int ACT>
cudaError_t launch_dx(const Args& a, bf16* dx) {
  const size_t bytes = DxLayout<H>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_dx_kernel<H, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ffn_bwd_dx_kernel<H, ACT><<<(a.T + BT - 1) / BT, THREADS, bytes, a.stream>>>(
      a.x, a.g, a.w1, a.b1, a.w2, dx, a.T, a.F, a.drop_thresh, a.inv_keep,
      a.seed);
  return cudaGetLastError();
}

template <int H, int ACT>
cudaError_t launch_dw(const Args& a, bf16* dw1, bf16* db1, bf16* dw2,
                      float* ws, int n_split) {
  const size_t bytes = DwLayout<H>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_dw_kernel<H, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.T + BT - 1) / BT;
  const int per_split = (n_tiles + n_split - 1) / n_split;
  dim3 grid(a.F / BFW, n_split);
  ffn_bwd_dw_kernel<H, ACT><<<grid, THREADS, bytes, a.stream>>>(
      a.x, a.g, a.w1, a.b1, a.w2, ws, a.T, a.F, per_split, a.drop_thresh,
      a.inv_keep, a.seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long HF = (long long)H * a.F;
  const long long n = 2 * HF + a.F;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ffn_dw_reduce_kernel<<<blocks, 256, 0, a.stream>>>(ws, n_split, HF, a.F,
                                                     dw1, dw2, db1);
  return cudaGetLastError();
}

template <int H, int ACT>
cudaError_t dispatch_pass(bool dw, const Args& a, bf16* dx, bf16* dw1,
                          bf16* db1, bf16* dw2, float* ws, int n_split) {
  return dw ? launch_dw<H, ACT>(a, dw1, db1, dw2, ws, n_split)
            : launch_dx<H, ACT>(a, dx);
}

template <int H>
cudaError_t dispatch_act(int act_id, bool dw, const Args& a, bf16* dx,
                         bf16* dw1, bf16* db1, bf16* dw2, float* ws,
                         int n_split) {
  switch (act_id) {
    case ACT_GELU:
      return dispatch_pass<H, ACT_GELU>(dw, a, dx, dw1, db1, dw2, ws, n_split);
    case ACT_GELU_TANH:
      return dispatch_pass<H, ACT_GELU_TANH>(dw, a, dx, dw1, db1, dw2, ws,
                                             n_split);
    case ACT_RELU:
      return dispatch_pass<H, ACT_RELU>(dw, a, dx, dw1, db1, dw2, ws, n_split);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int H, int act_id, bool dw, const Args& a, bf16* dx,
                     bf16* dw1, bf16* db1, bf16* dw2, float* ws,
                     int n_split) {
  switch (H) {
    case 128: return dispatch_act<128>(act_id, dw, a, dx, dw1, db1, dw2, ws, n_split);
    case 256: return dispatch_act<256>(act_id, dw, a, dx, dw1, db1, dw2, ws, n_split);
    case 512: return dispatch_act<512>(act_id, dw, a, dx, dw1, db1, dw2, ws, n_split);
    case 768: return dispatch_act<768>(act_id, dw, a, dx, dw1, db1, dw2, ws, n_split);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* x, const void* g, const void* w1, const void* b1,
               const void* w2, int T, int F, unsigned int drop_thresh,
               float inv_keep, unsigned int seed, void* stream) {
  return Args{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
              static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
              static_cast<const bf16*>(w2), T, F, drop_thresh, inv_keep,
              seed, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// act_id: 0 gelu (A-S erf), 1 gelu_tanh, 2 relu; inv_keep = 1 / (1 - p).
// ws: n_split x (2*H*F + F) f32 scratch.  Two launches: the dW pass and
// the reduce over splits.
int ffn_bwd_dw_bf16(const void* x, const void* g, const void* w1,
                    const void* b1, const void* w2, void* dw1, void* db1,
                    void* dw2, void* ws, int T, int H, int F, int act_id,
                    int n_split, unsigned int drop_thresh, float inv_keep,
                    unsigned int seed, void* stream) {
  const Args a = make_args(x, g, w1, b1, w2, T, F, drop_thresh, inv_keep,
                           seed, stream);
  return (int)dispatch(H, act_id, true, a, nullptr, static_cast<bf16*>(dw1),
                       static_cast<bf16*>(db1), static_cast<bf16*>(dw2),
                       static_cast<float*>(ws), n_split);
}

int ffn_bwd_dx_bf16(const void* x, const void* g, const void* w1,
                    const void* b1, const void* w2, void* dx, int T, int H,
                    int F, int act_id, unsigned int drop_thresh,
                    float inv_keep, unsigned int seed, void* stream) {
  const Args a = make_args(x, g, w1, b1, w2, T, F, drop_thresh, inv_keep,
                           seed, stream);
  return (int)dispatch(H, act_id, false, a, static_cast<bf16*>(dx), nullptr,
                       nullptr, nullptr, nullptr, 0);
}

}  // extern "C"
