// Ragged paged attention for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_ragged_paged_kernel
// (launched by _ragged_paged_forward), the attention of the serving decode
// path.  It computes the same function:
//
//   pages of sequence b: i = 0 .. W-1, taking part only if
//                        i == 0 or i * S < lengths[b]   (page 0 always, so
//                        a length-0 lane yields the uniform softmax over it)
//   s   = (q k^T) * scale                               (f32)
//   s   = DEFAULT_MASK_VALUE where kpos > qpos[b, t]
//   online softmax over the pages' keys: m, l, acc      (f32)
//   acc = alpha * acc + bf16(p) v
//   o   = acc / l                                       (bf16)
//
// Layout: page_rows (B, W) int32, lengths (B,) int32, q (B, T, H, D),
// k/v pools (P, S, H, D) (one layer's plane of a multi-layer pool),
// qpos (B, T) int32, o (B, T, H, D); all contiguous.  The page ids are
// read here, inside the kernel, straight from page_rows: nothing gathers
// the (B, W*S) keys of a sequence into a dense tensor.  Page ids are
// clamped to [0, P) so a stale row can never read outside the pool.
//
// Design: one CTA of 4 warps per (tile of up to 16 query rows, head,
// sequence).  The included pages form a prefix of the row, so the keys
// to visit are the logical positions 0 .. n_pages*S-1; they are cut into
// blocks of 32 keys, one key per lane, and the 4 warps take the blocks in
// turn (split-K inside the CTA: a decode step, T = 1, keeps all four warps
// busy).  A warp stages its block's K and V rows for head h in its own
// shared-memory slice (16-byte loads, page looked up per key), scores the
// block for each of the tile's rows (lane j: key j, f32 dot over D),
// runs the online softmax with warp shuffles, and adds bf16(p) V into f32
// accumulators kept in registers (lane: columns lane, lane+32, ...).  At
// the end the four warps' (m, l, acc) are merged through shared memory.
// All products are f32 FMAs on the CUDA cores.
//
// Bound on the H100: decode (T = 1) does 4*D flops per key against 4*D
// bytes of K and V per key and head: far below the bf16 ridge, so it is
// bound by the bytes of the included pages.  A chunk step (T = 256) does
// 256 times the flops on the same bytes, near the ridge.  This simple
// kernel uses neither cp.async/TMA pipelining nor tensor cores, and runs
// one 32-key block per warp at a time; making it fast (flash-decoding
// split over CTAs for T = 1, wgmma for chunk tiles) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TQ = 16;  // query rows per CTA
constexpr int KB = 32;  // keys per warp step, one per lane
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

template <int D>
struct Layout {
  // bf16 K row stride: D/2 + 1 words, an odd count, so 32 lanes reading
  // 32 different rows at one column hit 32 different banks
  static constexpr int LDK = D + 2;
  static constexpr int DU = D >= 32 ? D / 32 : 1;  // output columns a lane
  static constexpr size_t Q = 0;                             // f32 TQ x D
  static constexpr size_t QP = align128(Q + TQ * D * 4);     // int TQ
  static constexpr size_t STAGE = align128(QP + TQ * 4);
  static constexpr size_t K_BYTES = align128(KB * LDK * 2);
  static constexpr size_t V_BYTES = align128(KB * D * 2);
  static constexpr size_t WARP_BYTES = K_BYTES + V_BYTES;
  // the merge of the warps' (m, l, acc) reuses the staging region
  static constexpr size_t MERGE_BYTES = WARPS * TQ * (D + 2) * 4;
  static constexpr size_t BYTES =
      align128(STAGE + cmax(WARPS * WARP_BYTES, MERGE_BYTES));
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

template <int D>
__global__ void __launch_bounds__(THREADS)
ragged_paged_kernel(const int* __restrict__ page_rows,
                    const int* __restrict__ lengths,
                    const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp,
                    const int* __restrict__ qpos, bf16* __restrict__ o,
                    int T, int H, int P, int S, int W, float scale) {
  using LT = Layout<D>;
  constexpr int DU = LT::DU;
  constexpr int CH = D / 8;  // 16-byte chunks in a K or V row
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + LT::Q);
  int* sQP = reinterpret_cast<int*>(smem + LT::QP);

  const int t0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_here = min(TQ, T - t0);

  for (int i = threadIdx.x; i < TQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    sQ[i] = r < rows_here
                ? __bfloat162float(
                      q[(((long long)b * T + t0 + r) * H + h) * D + c])
                : 0.f;
  }
  for (int i = threadIdx.x; i < TQ; i += THREADS)
    sQP[i] = i < rows_here ? qpos[(long long)b * T + t0 + i] : 0;
  __syncthreads();

  // the included pages are the prefix 0 .. n_pages-1: i*S < len for
  // i < ceil(len/S), and page 0 always
  const int len = lengths[b];
  int n_pages = len > 0 ? (len + S - 1) / S : 1;
  n_pages = max(1, min(n_pages, W));
  const int n_keys = n_pages * S;
  const int n_blocks = (n_keys + KB - 1) / KB;
  const int* row = page_rows + (long long)b * W;
  const long long page_stride = (long long)S * H * D;
  const long long key_stride = (long long)H * D;

  bf16* sK = reinterpret_cast<bf16*>(smem + LT::STAGE +
                                     warp * LT::WARP_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + LT::STAGE +
                                     warp * LT::WARP_BYTES + LT::K_BYTES);

  float m[TQ], l[TQ], acc[TQ][DU];
#pragma unroll
  for (int r = 0; r < TQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < DU; ++u) acc[r][u] = 0.f;
  }

  for (int blk = warp; blk < n_blocks; blk += WARPS) {
    const int k0 = blk * KB;
    // stage the block's K and V rows of head h, 16 bytes a lane a step;
    // keys past the included pages are zero (and excluded below)
    for (int i = lane; i < KB * CH; i += 32) {
      const int j = i / CH, c = i % CH;
      const int kpos = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kpos < n_keys) {
        const int page = min(max(row[kpos / S], 0), P - 1);
        const long long off = page * page_stride +
                              (long long)(kpos % S) * key_stride +
                              (long long)h * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(kp + off);
        vv = *reinterpret_cast<const uint4*>(vp + off);
      }
      // the padded K row stride is 4-byte aligned only: four 32-bit stores
      uint32_t* kd = reinterpret_cast<uint32_t*>(sK + j * LT::LDK + c * 8);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<uint4*>(sV + j * D + c * 8) = vv;
    }
    __syncwarp();

    const int kpos = k0 + lane;
    const bool included = kpos < n_keys;
    const __nv_bfloat162* krow =
        reinterpret_cast<const __nv_bfloat162*>(sK + lane * LT::LDK);
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
      if (r < rows_here) {
        const float2* qr = reinterpret_cast<const float2*>(sQ + r * D);
        float s = 0.f;
#pragma unroll
        for (int p2 = 0; p2 < D / 2; ++p2) {
          const float2 kf = __bfloat1622float2(krow[p2]);
          const float2 qf = qr[p2];
          s = fmaf(qf.x, kf.x, s);
          s = fmaf(qf.y, kf.y, s);
        }
        s *= scale;
        if (kpos > sQP[r]) s = MASK_VALUE;
        if (!included) s = -INFINITY;
        // every block holds an included key (lane 0's), so m_new is finite
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = expf(s - m_new);
        const float alpha = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] = alpha * l[r] + warp_sum(p);
        const float pb = __bfloat162float(__float2bfloat16(p));
#pragma unroll
        for (int u = 0; u < DU; ++u) acc[r][u] *= alpha;
        for (int c = 0; c < KB; ++c) {
          const float pc = __shfl_sync(0xffffffffu, pb, c);
#pragma unroll
          for (int u = 0; u < DU; ++u) {
            const int d = lane + 32 * u;
            if (d < D)
              acc[r][u] = fmaf(pc, __bfloat162float(sV[c * D + d]),
                               acc[r][u]);
          }
        }
      }
    }
    __syncwarp();  // done with sK/sV before the next block overwrites them
  }

  // merge the four warps' partial softmaxes
  __syncthreads();  // every warp is done with the staging region
  float* cAcc = reinterpret_cast<float*>(smem + LT::STAGE);  // [W][TQ][D]
  float* cM = cAcc + WARPS * TQ * D;                          // [W][TQ]
  float* cL = cM + WARPS * TQ;
#pragma unroll
  for (int r = 0; r < TQ; ++r) {
    if (r < rows_here) {
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        const int d = lane + 32 * u;
        if (d < D) cAcc[(warp * TQ + r) * D + d] = acc[r][u];
      }
      if (lane == 0) {
        cM[warp * TQ + r] = m[r];
        cL[warp * TQ + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows_here * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, cM[w * TQ + r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      // a warp that took no block holds m = -inf, l = 0, acc = 0
      const float f = expf(cM[w * TQ + r] - mx);
      lsum += f * cL[w * TQ + r];
      out += f * cAcc[(w * TQ + r) * D + d];
    }
    o[(((long long)b * T + t0 + r) * H + h) * D + d] =
        __float2bfloat16(out / lsum);
  }
}

template <int D>
cudaError_t launch(const int* rows, const int* lens, const void* q,
                   const void* kp, const void* vp, const int* qpos, void* o,
                   int B, int T, int H, int P, int S, int W, float scale,
                   cudaStream_t stream) {
  const size_t bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + TQ - 1) / TQ, H, B);
  ragged_paged_kernel<D><<<grid, THREADS, bytes, stream>>>(
      rows, lens, static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), qpos, static_cast<bf16*>(o), T, H, P, S,
      W, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ragged_paged_bf16(const void* page_rows, const void* lengths,
                      const void* q, const void* k_pages,
                      const void* v_pages, const void* qpos, void* o, int B,
                      int T, int H, int D, int P, int S, int W, float scale,
                      void* stream) {
  const int* rows = static_cast<const int*>(page_rows);
  const int* lens = static_cast<const int*>(lengths);
  const int* qp = static_cast<const int*>(qpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S % 8 != 0 || T < 1 || W < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch<16>(rows, lens, q, k_pages, v_pages, qp, o, B, T, H, P,
                        S, W, scale, s);
    case 32:
      return launch<32>(rows, lens, q, k_pages, v_pages, qp, o, B, T, H, P,
                        S, W, scale, s);
    case 64:
      return launch<64>(rows, lens, q, k_pages, v_pages, qp, o, B, T, H, P,
                        S, W, scale, s);
    case 128:
      return launch<128>(rows, lens, q, k_pages, v_pages, qp, o, B, T, H, P,
                         S, W, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
