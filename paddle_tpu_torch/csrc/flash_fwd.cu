// Flash-attention forward for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_fwd_kernel (launched
// by _flash_forward) together with the transpose-and-pad shim of
// flash_attention.  It computes the same function:
//
//   s   = (q k^T) * scale + kbias[b, k]          (f32)
//   s   = DEFAULT_MASK_VALUE where causal and q + causal_offset < k
//   online softmax over key tiles: m, l, acc     (f32)
//   p~  = keep(seed, bh, q, k) ? p / (1 - p_drop) : 0   (_keep_mask3 hash)
//   acc = alpha * acc + bf16(p~) v
//   o   = acc / l (bf16),  lse = m + log(l) (f32)
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, H, D) read in place by strides (the
// last dim contiguous), o (B, Sq, H, D) contiguous, lse (B, H, Sq).  The
// ragged Sq/Sk edges are masked here, so nothing is padded or transposed
// around the call.  Keys past Sk are left out of the softmax entirely.
//
// Design: one CTA of 4 warps per (batch*head, 64-query tile); the loop over
// 64-key tiles inside the CTA takes the place of the TPU's sequential `ik`
// grid axis.  Each warp owns 16 query rows.  Q, K, V, the f32 scores, the
// bf16 probabilities and the f32 accumulator live in shared memory (about
// 71 KB at D=64, so three CTAs fit on an SM); m and l are per-row values in
// shared memory.  Both products run on the tensor cores through WMMA
// (bf16 x bf16 -> f32, 16x16x16 fragments).  The accumulator is kept in
// shared memory, not in fragments, because the per-row rescale by alpha
// needs to know which element is which row.
//
// Bound on the H100: at BERT-base shapes (S=512, D=64) the work is about
// 4*S*S*D flops per head against 4*S*D*2 bytes of q/k/v/o, i.e. ~256
// flop/byte, just under the card's ~295 bf16 ridge: it is memory-bound at
// the roofline, though this simple kernel (no cp.async/TMA pipelining, no
// wgmma) is far from either roof.  Making it fast is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per CTA, 16 per warp
constexpr int BK = 64;  // keys per inner step
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 q/k/v tile row stride
  static constexpr int LDS = BK + 4;  // f32 score row stride
  static constexpr int LDP = BK + 8;  // bf16 probability row stride
  static constexpr int LDO = D + 4;   // f32 accumulator row stride
  static constexpr size_t Q = 0;
  static constexpr size_t K = align128(Q + BQ * LDH * 2);
  static constexpr size_t V = align128(K + BK * LDH * 2);
  static constexpr size_t S = align128(V + BK * LDH * 2);
  static constexpr size_t P = align128(S + BQ * LDS * 4);
  static constexpr size_t O = align128(P + BQ * LDP * 2);
  static constexpr size_t BIAS = align128(O + BQ * LDO * 4);
  static constexpr size_t M = align128(BIAS + BK * 4);
  static constexpr size_t L = align128(M + BQ * 4);
  static constexpr size_t BYTES = align128(L + BQ * 4);
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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ kbias,
                 bf16* __restrict__ o, float* __restrict__ lse, int H,
                 int Sq, int Sk, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, int causal, int causal_offset, float scale,
                 uint32_t drop_thresh, float keep_prob, uint32_t seed) {
  using LT = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + LT::Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + LT::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + LT::V);
  float* sS = reinterpret_cast<float*>(smem + LT::S);
  bf16* sP = reinterpret_cast<bf16*>(smem + LT::P);
  float* sO = reinterpret_cast<float*>(smem + LT::O);
  float* sBias = reinterpret_cast<float*>(smem + LT::BIAS);
  float* sM = reinterpret_cast<float*>(smem + LT::M);
  float* sL = reinterpret_cast<float*>(smem + LT::L);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_w = warp * 16;  // this warp's first row in the tile

  load_tile<D>(sQ, q + b * q_sb + h * q_sh, q_ss, q0, BQ, Sq);
  for (int i = threadIdx.x; i < BQ * LT::LDO; i += THREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    // every row of this q tile keeps key 0 (q0 + offset >= 0), so tiles
    // wholly above the causal diagonal contribute exp(MASK - m) == 0
    if (causal && q0 + causal_offset >= 0 &&
        k0 > q0 + BQ - 1 + causal_offset)
      break;
    __syncthreads();  // the previous step is done with sK/sV/sBias
    load_tile<D>(sK, k + b * k_sb + h * k_sh, k_ss, k0, BK, Sk);
    load_tile<D>(sV, v + b * v_sb + h * v_sh, v_ss, k0, BK, Sk);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      sBias[i] = (kbias != nullptr && k0 + i < Sk)
                     ? kbias[(long long)b * Sk + k0 + i] : 0.f;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + row_w * LT::LDH + kk * 16, LT::LDH);
        wmma::load_matrix_sync(fb, sK + nt * 16 * LT::LDH + kk * 16, LT::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + row_w * LT::LDS + nt * 16, acc, LT::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update, one row at a time across the warp's lanes
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row_w + rr;
      const int qrow = q0 + r;
      float sv[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        const int kc = k0 + c;
        float s = -INFINITY;
        if (kc < Sk) {
          s = sS[r * LT::LDS + c] * scale + sBias[c];
          if (causal && qrow + causal_offset < kc) s = MASK_VALUE;
          mx = fmaxf(mx, s);
        }
        sv[j] = s;
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        const int kc = k0 + c;
        float p = kc < Sk ? expf(sv[j] - m_new) : 0.f;
        psum += p;
        if (drop_thresh != 0u) {
          const bool keep = keep_hash(seed, (uint32_t)bh, (uint32_t)qrow,
                                      (uint32_t)kc) >= drop_thresh;
          p = keep ? p / keep_prob : 0.f;
        }
        sP[r * LT::LDP + c] = __float2bfloat16(p);
      }
      psum = warp_sum(psum);
      const float alpha = expf(m_prev - m_new);
      for (int c = lane; c < D; c += 32) sO[r * LT::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = alpha * sL[r] + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + row_w * LT::LDO + nt * 16, LT::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + row_w * LT::LDP + kk * 16, LT::LDP);
        wmma::load_matrix_sync(fb, sV + kk * 16 * LT::LDH + nt * 16, LT::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + row_w * LT::LDO + nt * 16, acc, LT::LDO,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();

  // o = acc / l, lse = m + log(l), for this warp's valid rows
  for (int rr = 0; rr < 16; ++rr) {
    const int r = row_w + rr;
    const int qrow = q0 + r;
    if (qrow >= Sq) break;
    const float l = sL[r];
    bf16* orow = o + (((long long)b * Sq + qrow) * H + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(sO[r * LT::LDO + c] / l);
    if (lane == 0) lse[(long long)bh * Sq + qrow] = sM[r] + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* kbias, void* o, float* lse, int B, int H,
                   int Sq, int Sk, const long long* st, int causal,
                   int causal_offset, float scale, uint32_t drop_thresh,
                   float keep_prob, uint32_t seed, cudaStream_t stream) {
  const size_t bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kbias, static_cast<bf16*>(o), lse, H, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, causal_offset, scale, drop_thresh, keep_prob, seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// strides (in elements): q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh
int flash_fwd_bf16(const void* q, const void* k, const void* v,
                   const void* kbias, void* o, void* lse, int B, int H,
                   int Sq, int Sk, int D, const long long* strides,
                   int causal, int causal_offset, float scale,
                   unsigned int drop_thresh, float keep_prob,
                   unsigned int seed, void* stream) {
  const float* kb = static_cast<const float*>(kbias);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, kb, o, ls, B, H, Sq, Sk, strides, causal,
                        causal_offset, scale, drop_thresh, keep_prob, seed, s);
    case 32:
      return launch<32>(q, k, v, kb, o, ls, B, H, Sq, Sk, strides, causal,
                        causal_offset, scale, drop_thresh, keep_prob, seed, s);
    case 64:
      return launch<64>(q, k, v, kb, o, ls, B, H, Sq, Sk, strides, causal,
                        causal_offset, scale, drop_thresh, keep_prob, seed, s);
    case 128:
      return launch<128>(q, k, v, kb, o, ls, B, H, Sq, Sk, strides, causal,
                         causal_offset, scale, drop_thresh, keep_prob, seed,
                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
