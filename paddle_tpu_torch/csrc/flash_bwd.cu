// Flash-attention backward for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_bwd_dkv_kernel and
// ::_flash_bwd_dq_kernel (launched by _flash_backward).  From the forward's
// saved lse and delta = rowsum(g * o) (a torch reduction in the wrapper, as
// in JAX) they recompute, per (query tile, key tile):
//
//   s   = (q k^T) * scale + kbias[b, k];  DEFAULT_MASK_VALUE where causal
//         and q + causal_offset < k                          (f32)
//   p   = exp(s - lse[q])
//   p~  = keep(seed, bh, q, k) ? p / (1 - p_drop) : 0        (_keep_mask3)
//   dp  = keep ? (g v^T) / (1 - p_drop) : 0
//   ds  = p * (dp - delta[q]) * scale
//   dkv kernel:  dV += bf16(p~)^T g,  dK += bf16(ds)^T q
//   dq kernel:   dQ += bf16(ds) k
//
// Layout: q/g (B, Sq, H, D), k/v (B, Sk, H, D) read in place by strides
// (the last dim contiguous); lse, delta (B, H, Sq) f32; dq (B, Sq, H, D),
// dk/dv (B, Sk, H, D) contiguous bf16.  Ragged Sq/Sk edges are masked here.
// Query and key tiles the forward skipped above the causal diagonal are
// skipped here too, so both passes see the same probabilities.
//
// Design: the TPU walked a sequential grid axis and kept dK/dV (or dQ) in
// VMEM scratch across it; CTAs on the card run in no order, so each CTA
// owns its output tile and loops itself:
//   dkv: one 4-warp CTA per (batch*head, 64-key tile), looping over 64-query
//        tiles; each warp owns 16 keys and holds their dK and dV in WMMA
//        accumulator fragments (f32) for the whole loop.
//   dq:  one 4-warp CTA per (batch*head, 64-query tile), looping over 64-key
//        tiles; each warp owns 16 queries and their dQ fragments.
// The per-row lse and delta (per column in the dkv pass) cannot be applied
// to a WMMA fragment, whose element order is opaque, so each score tile and
// its dP tile go through shared memory in f32 (the forward kernel's layout),
// are turned elementwise into bf16 p~ and dS tiles, and feed the next
// products from there.  About 91 KB of shared memory at D=64: two CTAs an
// SM.  At BERT-base shapes (B=32, S=512, H=12) each grid is 8 x 384 = 3072
// CTAs.
//
// Bound on the H100: at S=512, D=64 the dkv pass does 4 products of
// 2*S*S*D flops per head (51.5 GFLOP at B=32, H=12) against ~150 MB of
// q/k/v/g/dk/dv, the dq pass 3 products against ~126 MB: both sit just
// over the bf16 ridge (~295 flop/byte), so the roofline bound is the tensor
// cores (0.052 and 0.039 ms).  This simple kernel recomputes the scores in
// both passes, runs WMMA (not wgmma) and does not overlap loads with math;
// it is far from that bound.  Making it fast is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 q/g/k/v tile row stride
  static constexpr int LDS = 64 + 4;  // f32 score / dP tile row stride
  static constexpr int LDP = 64 + 8;  // bf16 p~ / dS tile row stride
  static constexpr int LDO = D + 4;   // f32 output staging row stride
  static constexpr size_t Q = 0;
  static constexpr size_t G = align128(Q + 64 * LDH * 2);
  static constexpr size_t K = align128(G + 64 * LDH * 2);
  static constexpr size_t V = align128(K + 64 * LDH * 2);
  static constexpr size_t S = align128(V + 64 * LDH * 2);
  static constexpr size_t DP = align128(S + 64 * LDS * 4);
  static constexpr size_t P = align128(DP + 64 * LDS * 4);
  static constexpr size_t DS = align128(P + 64 * LDP * 2);
  static constexpr size_t BIAS = align128(DS + 64 * LDP * 2);
  static constexpr size_t LSE = align128(BIAS + 64 * 4);
  static constexpr size_t DELTA = align128(LSE + 64 * 4);
  static constexpr size_t BYTES = align128(DELTA + 64 * 4);
  // the output tile is staged in f32 over the score and dP tiles
  static_assert(P - S >= 64 * LDO * 4, "staging must fit over S and DP");
};

// paddle_tpu/ops/pallas/attention.py::_keep_mask3, bit for bit
__device__ __forceinline__ uint32_t keep_hash(uint32_t seed, uint32_t bh,
                                              uint32_t r, uint32_t c) {
  uint32_t x = (r * 0x9E3779B1u) ^ (c * 0x85EBCA77u);
  x ^= (bh + 1u) * 0x27D4EB2Fu;
  x ^= seed * 0x165667B1u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// rows x D tile of a (B, S, H, D)-strided tensor into shared memory,
// 16 bytes per thread per step; rows past `limit` are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int rows, int limit) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDH + c * 8) = val;
  }
}

// per-row f32 values (lse or delta) of rows [row0, row0 + 64); 0 past limit
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int limit) {
  for (int i = threadIdx.x; i < 64; i += THREADS)
    dst[i] = row0 + i < limit ? src[row0 + i] : 0.f;
}

// the key bias of keys [k0, k0 + 64); 0 past Sk or without a bias
__device__ __forceinline__ void load_bias(float* dst, const float* kbias,
                                          int b, int k0, int Sk) {
  for (int i = threadIdx.x; i < 64; i += THREADS)
    dst[i] = (kbias != nullptr && k0 + i < Sk)
                 ? kbias[(long long)b * Sk + k0 + i] : 0.f;
}

// the forward skips key tiles wholly above the causal diagonal of a query
// tile whose first row keeps key 0; the backward skips the same pairs
__device__ __forceinline__ bool skipped(int causal, int q0, int k0,
                                        int causal_offset) {
  return causal && q0 + causal_offset >= 0 &&
         k0 > q0 + BQ - 1 + causal_offset;
}

// C (16 x 64) = A (16 x D, row-major at a) times B^T, where B is 64 rows of
// D at b (so B^T is read column-major): the 16 rows of this warp against a
// whole 64-row tile, stored as f32 at c with row stride LDS
template <int D>
__device__ __forceinline__ void rows_times_tile_t(const bf16* a,
                                                  const bf16* b, float* c) {
  using LT = Layout<D>;
#pragma unroll
  for (int nt = 0; nt < 64 / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LT::LDH);
      wmma::load_matrix_sync(fb, b + nt * 16 * LT::LDH + kk * 16, LT::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, LT::LDS, wmma::mem_row_major);
  }
}

// acc[nt] (16 x D) += A (16 x 64 bf16 at a, row stride LDP) times the
// 64 x D tile at b
template <int D>
__device__ __forceinline__ void accumulate(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    const bf16* a, const bf16* b) {
  using LT = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LT::LDP);
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LT::LDH + nt * 16, LT::LDH);
      wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
    }
  }
}

// write this warp's 16 rows of acc as bf16 rows of a (B, S, H, D)
// contiguous output, staged through f32 shared memory at stage
template <int D>
__device__ __forceinline__ void write_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float* stage, bf16* out, int b, int h, int H, int S, int row0,
    int row_w) {
  using LT = Layout<D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt)
    wmma::store_matrix_sync(stage + row_w * LT::LDO + nt * 16, acc[nt],
                            LT::LDO, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = row_w + rr;
    if (row0 + r >= S) break;
    bf16* orow = out + (((long long)b * S + row0 + r) * H + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(stage[r * LT::LDO + c]);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ kbias,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long g_sb, long long g_ss, long long g_sh,
                     int causal, int causal_offset, float scale,
                     uint32_t drop_thresh, float inv_keep, uint32_t seed) {
  using LT = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + LT::Q);
  bf16* sG = reinterpret_cast<bf16*>(smem + LT::G);
  bf16* sK = reinterpret_cast<bf16*>(smem + LT::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + LT::V);
  float* sS = reinterpret_cast<float*>(smem + LT::S);
  float* sDP = reinterpret_cast<float*>(smem + LT::DP);
  bf16* sP = reinterpret_cast<bf16*>(smem + LT::P);
  bf16* sDS = reinterpret_cast<bf16*>(smem + LT::DS);
  float* sBias = reinterpret_cast<float*>(smem + LT::BIAS);
  float* sLse = reinterpret_cast<float*>(smem + LT::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + LT::DELTA);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_w = warp * 16;  // this warp's first key in the tile

  load_tile<D>(sK, k + b * k_sb + h * k_sh, k_ss, k0, BK, Sk);
  load_tile<D>(sV, v + b * v_sb + h * v_sh, v_ss, k0, BK, Sk);
  load_bias(sBias, kbias, b, k0, Sk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dk[D / 16],
      acc_dv[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fill_fragment(acc_dk[nt], 0.f);
    wmma::fill_fragment(acc_dv[nt], 0.f);
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    if (skipped(causal, q0, k0, causal_offset)) continue;
    __syncthreads();  // the previous step is done with the query-side tiles
    load_tile<D>(sQ, q + b * q_sb + h * q_sh, q_ss, q0, BQ, Sq);
    load_tile<D>(sG, g + b * g_sb + h * g_sh, g_ss, q0, BQ, Sq);
    load_rows(sLse, lse + (long long)bh * Sq, q0, Sq);
    load_rows(sDelta, delta + (long long)bh * Sq, q0, Sq);
    __syncthreads();

    // S^T = K Q^T and dP~^T = V G^T for this warp's 16 keys
    rows_times_tile_t<D>(sK + row_w * LT::LDH, sQ, sS + row_w * LT::LDS);
    rows_times_tile_t<D>(sV + row_w * LT::LDH, sG, sDP + row_w * LT::LDS);
    __syncwarp();

    // rows are keys, columns queries
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row_w + rr;
      const int kc = k0 + r;
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        const int c = lane + 32 * j;
        const int qr = q0 + c;
        float pd = 0.f, ds = 0.f;
        if (qr < Sq && kc < Sk) {
          float s = sS[r * LT::LDS + c] * scale + sBias[r];
          if (causal && qr + causal_offset < kc) s = MASK_VALUE;
          const float p = expf(s - sLse[c]);
          float dp = sDP[r * LT::LDS + c];
          pd = p;
          if (drop_thresh != 0u) {
            const bool keep = keep_hash(seed, (uint32_t)bh, (uint32_t)qr,
                                        (uint32_t)kc) >= drop_thresh;
            pd = keep ? p * inv_keep : 0.f;
            dp = keep ? dp * inv_keep : 0.f;
          }
          ds = p * (dp - sDelta[c]) * scale;
        }
        sP[r * LT::LDP + c] = __float2bfloat16(pd);
        sDS[r * LT::LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dV += P~^T G and dK += dS^T Q for this warp's 16 keys
    accumulate<D>(acc_dv, sP + row_w * LT::LDP, sG);
    accumulate<D>(acc_dk, sDS + row_w * LT::LDP, sQ);
  }
  __syncthreads();  // every warp is done with sS/sDP: stage over them

  write_rows<D>(acc_dv, sS, dv, b, h, H, Sk, k0, row_w);
  write_rows<D>(acc_dk, sS, dk, b, h, H, Sk, k0, row_w);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ kbias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Sq, int Sk, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long g_sb, long long g_ss,
                    long long g_sh, int causal, int causal_offset,
                    float scale, uint32_t drop_thresh, float inv_keep,
                    uint32_t seed) {
  using LT = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + LT::Q);
  bf16* sG = reinterpret_cast<bf16*>(smem + LT::G);
  bf16* sK = reinterpret_cast<bf16*>(smem + LT::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + LT::V);
  float* sS = reinterpret_cast<float*>(smem + LT::S);
  float* sDP = reinterpret_cast<float*>(smem + LT::DP);
  bf16* sDS = reinterpret_cast<bf16*>(smem + LT::DS);
  float* sBias = reinterpret_cast<float*>(smem + LT::BIAS);
  float* sLse = reinterpret_cast<float*>(smem + LT::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + LT::DELTA);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_w = warp * 16;  // this warp's first query in the tile

  load_tile<D>(sQ, q + b * q_sb + h * q_sh, q_ss, q0, BQ, Sq);
  load_tile<D>(sG, g + b * g_sb + h * g_sh, g_ss, q0, BQ, Sq);
  load_rows(sLse, lse + (long long)bh * Sq, q0, Sq);
  load_rows(sDelta, delta + (long long)bh * Sq, q0, Sq);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dq[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) wmma::fill_fragment(acc_dq[nt], 0.f);

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    if (skipped(causal, q0, k0, causal_offset)) break;
    __syncthreads();  // the previous step is done with the key-side tiles
    load_tile<D>(sK, k + b * k_sb + h * k_sh, k_ss, k0, BK, Sk);
    load_tile<D>(sV, v + b * v_sb + h * v_sh, v_ss, k0, BK, Sk);
    load_bias(sBias, kbias, b, k0, Sk);
    __syncthreads();

    // S = Q K^T and dP~ = G V^T for this warp's 16 queries
    rows_times_tile_t<D>(sQ + row_w * LT::LDH, sK, sS + row_w * LT::LDS);
    rows_times_tile_t<D>(sG + row_w * LT::LDH, sV, sDP + row_w * LT::LDS);
    __syncwarp();

    // rows are queries, columns keys
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row_w + rr;
      const int qr = q0 + r;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        const int kc = k0 + c;
        float ds = 0.f;
        if (qr < Sq && kc < Sk) {
          float s = sS[r * LT::LDS + c] * scale + sBias[c];
          if (causal && qr + causal_offset < kc) s = MASK_VALUE;
          const float p = expf(s - sLse[r]);
          float dp = sDP[r * LT::LDS + c];
          if (drop_thresh != 0u) {
            const bool keep = keep_hash(seed, (uint32_t)bh, (uint32_t)qr,
                                        (uint32_t)kc) >= drop_thresh;
            dp = keep ? dp * inv_keep : 0.f;
          }
          ds = p * (dp - sDelta[r]) * scale;
        }
        sDS[r * LT::LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ += dS K for this warp's 16 queries
    accumulate<D>(acc_dq, sDS + row_w * LT::LDP, sK);
  }
  __syncthreads();  // every warp is done with sS/sDP: stage over them

  write_rows<D>(acc_dq, sS, dq, b, h, H, Sq, q0, row_w);
}

struct Args {
  const bf16 *q, *k, *v, *g;
  const float *kbias, *lse, *delta;
  int B, H, Sq, Sk;
  const long long* st;
  int causal, causal_offset;
  float scale;
  uint32_t drop_thresh;
  float inv_keep;
  uint32_t seed;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkv(const Args& a, bf16* dk, bf16* dv) {
  const size_t bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
  const long long* s = a.st;
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, a.stream>>>(
      a.q, a.k, a.v, a.g, a.kbias, a.lse, a.delta, dk, dv, a.H, a.Sq, a.Sk,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10],
      s[11], a.causal, a.causal_offset, a.scale, a.drop_thresh, a.inv_keep,
      a.seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  const size_t bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  const long long* s = a.st;
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, a.stream>>>(
      a.q, a.k, a.v, a.g, a.kbias, a.lse, a.delta, dq, a.H, a.Sq, a.Sk,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10],
      s[11], a.causal, a.causal_offset, a.scale, a.drop_thresh, a.inv_keep,
      a.seed);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* kbias, const void* lse, const void* delta, int B,
               int H, int Sq, int Sk, const long long* strides, int causal,
               int causal_offset, float scale, unsigned int drop_thresh,
               float inv_keep, unsigned int seed, void* stream) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<const bf16*>(g),
              static_cast<const float*>(kbias),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta), B, H, Sq, Sk, strides,
              causal, causal_offset, scale, drop_thresh, inv_keep, seed,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// strides (in elements): q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
// v_sh, g_sb, g_ss, g_sh.  kbias may be null.  inv_keep = 1 / (1 - p_drop).
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* g, const void* kbias, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int D, const long long* strides,
                       int causal, int causal_offset, float scale,
                       unsigned int drop_thresh, float inv_keep,
                       unsigned int seed, void* stream) {
  const Args a = make_args(q, k, v, g, kbias, lse, delta, B, H, Sq, Sk,
                           strides, causal, causal_offset, scale,
                           drop_thresh, inv_keep, seed, stream);
  bf16* k_out = static_cast<bf16*>(dk);
  bf16* v_out = static_cast<bf16*>(dv);
  switch (D) {
    case 16: return launch_dkv<16>(a, k_out, v_out);
    case 32: return launch_dkv<32>(a, k_out, v_out);
    case 64: return launch_dkv<64>(a, k_out, v_out);
    case 128: return launch_dkv<128>(a, k_out, v_out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* g, const void* kbias, const void* lse,
                      const void* delta, void* dq, int B, int H, int Sq,
                      int Sk, int D, const long long* strides, int causal,
                      int causal_offset, float scale,
                      unsigned int drop_thresh, float inv_keep,
                      unsigned int seed, void* stream) {
  const Args a = make_args(q, k, v, g, kbias, lse, delta, B, H, Sq, Sk,
                           strides, causal, causal_offset, scale,
                           drop_thresh, inv_keep, seed, stream);
  bf16* q_out = static_cast<bf16*>(dq);
  switch (D) {
    case 16: return launch_dq<16>(a, q_out);
    case 32: return launch_dq<32>(a, q_out);
    case 64: return launch_dq<64>(a, q_out);
    case 128: return launch_dq<128>(a, q_out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
