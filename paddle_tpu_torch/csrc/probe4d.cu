// The three layout-probe kernels for Hopper (sm_90a): bf16 in, f32 math.
//
// Replace the three Pallas kernels of tools/kernel4d_probe.py, which price
// the layout question behind the flash kernels (read the projection output
// in place, or pay the merge transposes to (B*H, S, D) on every call):
//
//   probe_4d_kernel      <- build        (:29)   q/k/v/o (B, S, H, D)
//   probe_fold3d_kernel  <- build_fold3d (:78)   q/k/v/o (B, S, H*D), head h
//                                                at lanes h*D .. h*D + D - 1
//   probe_merged_kernel  <- main's kernel3 (:226) q/k/v/o (B*H, S, D)
//
// Each computes, per (batch, head), one-shot softmax attention with no
// mask, exactly as kernel4d_probe.py:43-56 does:
//
//   s = (q k^T) * scale            f32, scale = 1/sqrt(D)
//   m = rowmax(s), p = exp(s - m), l = rowsum(p)        f32
//   P = bf16(p / l)                normalised BEFORE the cast
//   o = bf16(P v)                  f32 accumulation, one cast
//
// The three kernels share one device body (attend<D>) and differ only in
// how they find a head's rows: by the (B, S, H, D) strides, at a lane
// offset of h*D in (B, S, H*D) rows, or as the plane b*H + h of the merged
// tensor.  On the same bytes, 4d and fold3d therefore give the same bits.
//
// Design: one CTA of 4 warps per (batch*head, 64-query tile); each warp
// owns 16 query rows.  The whole 64 x S f32 score block lives in dynamic
// shared memory (as the TPU kernel holds the whole (S, D) K/V block in
// VMEM), so S is limited: 64 x (S + 4) x 4 bytes plus the Q and K/V tiles
// must fit the 227 KB a block may use, which holds up to S = 768 at every
// head dim (the wrapper raises above it).  Keys are staged in 64-row
// tiles; both products run on the tensor cores through WMMA (bf16 x bf16
// -> f32, 16x16x16).  The softmax takes one row at a time across a warp's
// lanes (a lane holds at most 24 scores in registers) and writes bf16 P
// back over the first half of the same row's f32 storage.  The P V
// accumulator stays in fragments, because P is already normalised and no
// row is rescaled.  Ragged S is masked here: key rows past S are zero and
// left out of the softmax, query rows past S are not written.
//
// Bound on the H100: at the tool's shape (8, 512, 12, 64) each call reads
// q/k/v and writes o once, 25.2 MB (7.5 us at 3.35 TB/s), against 6.4
// GFLOP (6.5 us at 989 TFLOP/s): bytes, just.  This simple kernel (no
// cp.async/TMA pipelining, no wgmma, one CTA an SM at S = 512 because the
// score block takes 129 KB) is far from either roof; making it fast is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per CTA, 16 per warp
constexpr int BK = 64;  // keys per staged K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_S = 768;
constexpr int MAX_PER_LANE = MAX_S / 32;  // scores of one row per lane

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <int D>
struct Smem {
  static constexpr int LDH = D + 8;  // bf16 row stride of the Q, K/V tiles
  // f32 row stride of the score block; it also holds the output rows in
  // the epilogue, so it is at least D wide
  __host__ __device__ static int lds(int s_pad) {
    return (s_pad > D ? s_pad : D) + 4;
  }
  __host__ __device__ static size_t q_off(int s_pad) {
    return align128((size_t)BQ * lds(s_pad) * 4);
  }
  __host__ __device__ static size_t kv_off(int s_pad) {
    return q_off(s_pad) + align128((size_t)BQ * LDH * 2);
  }
  __host__ __device__ static size_t bytes(int s_pad) {
    return kv_off(s_pad) + align128((size_t)BK * LDH * 2);
  }
};

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

// rows x D tile of rows `row_stride` elements apart into shared memory,
// 16 bytes per thread per step; rows at or past `limit` are zero
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
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LDH + c * 8) = val;
  }
}

// One (batch, head) of one-shot attention for the 64 queries from q0 on.
// q/k/v/o point at the head's row 0; consecutive rows are *_ss apart.
template <int D>
__device__ __forceinline__ void attend(const bf16* __restrict__ q,
                                       long long q_ss,
                                       const bf16* __restrict__ k,
                                       long long k_ss,
                                       const bf16* __restrict__ v,
                                       long long v_ss, bf16* __restrict__ o,
                                       long long o_ss, int S, float scale) {
  using SM = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int s_pad = (S + BK - 1) / BK * BK;
  const int lds = SM::lds(s_pad);
  const int ldp = 2 * lds;  // the same rows read as bf16
  float* sS = reinterpret_cast<float*>(smem);
  bf16* sP = reinterpret_cast<bf16*>(smem);
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::q_off(s_pad));
  bf16* sKV = reinterpret_cast<bf16*>(smem + SM::kv_off(s_pad));

  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_w = warp * 16;  // this warp's first row in the tile

  load_tile<D>(sQ, q, q_ss, q0, BQ, S);

  // scores = Q K^T, one 64-key tile at a time
  for (int k0 = 0; k0 < s_pad; k0 += BK) {
    __syncthreads();  // Q is loaded; the previous tile is consumed
    load_tile<D>(sKV, k, k_ss, k0, BK, S);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + row_w * SM::LDH + kk * 16, SM::LDH);
        wmma::load_matrix_sync(fb, sKV + nt * 16 * SM::LDH + kk * 16,
                               SM::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + row_w * lds + k0 + nt * 16, acc, lds,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();

  // softmax of this warp's rows; P = bf16(p / l) over the row's own bytes
  const int per_lane = s_pad / 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = row_w + rr;
    float sv[MAX_PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAX_PER_LANE; ++j) {
      if (j < per_lane) {
        const int c = lane + 32 * j;
        const float s = c < S ? sS[r * lds + c] * scale : -INFINITY;
        sv[j] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = warp_max(mx);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_PER_LANE; ++j) {
      if (j < per_lane) {
        const int c = lane + 32 * j;
        const float p = c < S ? expf(sv[j] - mx) : 0.f;
        sv[j] = p;
        l += p;
      }
    }
    l = warp_sum(l);
    __syncwarp();  // every lane has read row r before it is overwritten
#pragma unroll
    for (int j = 0; j < MAX_PER_LANE; ++j) {
      if (j < per_lane)
        sP[r * ldp + lane + 32 * j] = __float2bfloat16(sv[j] / l);
    }
  }
  __syncwarp();

  // O = P V, V staged in 64-key tiles, the accumulator in fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) wmma::fill_fragment(acc[nt], 0.f);
  for (int k0 = 0; k0 < s_pad; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(sKV, v, v_ss, k0, BK, S);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sP + row_w * ldp + k0 + kk * 16, ldp);
#pragma unroll
      for (int nt = 0; nt < D / 16; ++nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sKV + kk * 16 * SM::LDH + nt * 16,
                               SM::LDH);
        wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
      }
    }
  }

  // epilogue: fragments into this warp's own score rows (only it reads
  // them), then one bf16 cast per element on the way out
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt)
    wmma::store_matrix_sync(sS + row_w * lds + nt * 16, acc[nt], lds,
                            wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = row_w + rr;
    const int qrow = q0 + r;
    if (qrow >= S) break;
    bf16* orow = o + (long long)qrow * o_ss;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(sS[r * lds + c]);
  }
}

// q/k/v (B, S, H, D) by strides (last dim contiguous); o (B, S, H, D)
// contiguous.  blockIdx.y = b*H + h.
template <int D>
__global__ void __launch_bounds__(THREADS)
probe_4d_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                int S, long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                float scale) {
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  attend<D>(q + b * q_sb + h * q_sh, q_ss, k + b * k_sb + h * k_sh, k_ss,
            v + b * v_sb + h * v_sh, v_ss,
            o + ((long long)b * S * H + h) * D, (long long)H * D, S, scale);
}

// q/k/v (B, S, H*D) with rows *_ss apart, head h at lane offset h*D; o
// (B, S, H*D) contiguous.  blockIdx.y = b*H + h.
template <int D>
__global__ void __launch_bounds__(THREADS)
probe_fold3d_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                    int S, long long q_sb, long long q_ss, long long k_sb,
                    long long k_ss, long long v_sb, long long v_ss,
                    float scale) {
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long lane0 = (long long)h * D;
  attend<D>(q + b * q_sb + lane0, q_ss, k + b * k_sb + lane0, k_ss,
            v + b * v_sb + lane0, v_ss,
            o + (long long)b * S * H * D + lane0, (long long)H * D, S,
            scale);
}

// q/k/v (B*H, S, D) with rows *_ss apart; o (B*H, S, D) contiguous.
// blockIdx.y = b*H + h, the plane.
template <int D>
__global__ void __launch_bounds__(THREADS)
probe_merged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                    long long q_sp, long long q_ss, long long k_sp,
                    long long k_ss, long long v_sp, long long v_ss,
                    float scale) {
  const long long bh = blockIdx.y;
  attend<D>(q + bh * q_sp, q_ss, k + bh * k_sp, k_ss, v + bh * v_sp, v_ss,
            o + bh * S * D, (long long)D, S, scale);
}

enum Layout { L4D, FOLD3D, MERGED };

template <Layout L, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, const long long* st, float scale,
                   cudaStream_t stream) {
  const int s_pad = (S + BK - 1) / BK * BK;
  const size_t bytes = Smem<D>::bytes(s_pad);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  cudaError_t err;
  if constexpr (L == L4D) {
    err = cudaFuncSetAttribute(probe_4d_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    probe_4d_kernel<D><<<grid, THREADS, bytes, stream>>>(
        qb, kb, vb, ob, H, S, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], scale);
  } else if constexpr (L == FOLD3D) {
    err = cudaFuncSetAttribute(probe_fold3d_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    probe_fold3d_kernel<D><<<grid, THREADS, bytes, stream>>>(
        qb, kb, vb, ob, H, S, st[0], st[1], st[2], st[3], st[4], st[5],
        scale);
  } else {
    err = cudaFuncSetAttribute(probe_merged_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    probe_merged_kernel<D><<<grid, THREADS, bytes, stream>>>(
        qb, kb, vb, ob, S, st[0], st[1], st[2], st[3], st[4], st[5], scale);
  }
  return cudaGetLastError();
}

template <Layout L>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int D, const long long* st, float scale,
             void* stream) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<L, 16>(q, k, v, o, B, S, H, st, scale, s);
    case 32: return launch<L, 32>(q, k, v, o, B, S, H, st, scale, s);
    case 64: return launch<L, 64>(q, k, v, o, B, S, H, st, scale, s);
    case 128: return launch<L, 128>(q, k, v, o, B, S, H, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// strides (elements): q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh
int probe_4d_bf16(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int D, const long long* strides,
                  float scale, void* stream) {
  return dispatch<L4D>(q, k, v, o, B, S, H, D, strides, scale, stream);
}

// strides (elements): q_sb, q_ss, k_sb, k_ss, v_sb, v_ss
int probe_fold3d_bf16(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int D, const long long* strides,
                      float scale, void* stream) {
  return dispatch<FOLD3D>(q, k, v, o, B, S, H, D, strides, scale, stream);
}

// (B*H, S, D) planes; strides (elements): q_sp, q_ss, k_sp, k_ss, v_sp,
// v_ss
int probe_merged_bf16(const void* q, const void* k, const void* v, void* o,
                      int planes, int S, int D, const long long* strides,
                      float scale, void* stream) {
  return dispatch<MERGED>(q, k, v, o, planes, S, 1, D, strides, scale,
                          stream);
}

}  // extern "C"
