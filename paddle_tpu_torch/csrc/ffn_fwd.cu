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
// contiguous; H in {128, 256, 512, 768, 1024}, F a multiple of 64, any
// T >= 1.  The (T, F) hidden activation never reaches device memory.
//
// Bound on the H100: 4*T*H*F flops against (2*T*H + 2*H*F + F + H)*2
// bytes.  At BERT-base widths (H=768, F=3072) that is 0.156 ms of tensor
// cores at T=16384 (1500 flop/byte: compute-bound) and 2.8 us of HBM at
// T=16 (the 9.4 MB of weights: byte-bound).
//
// Design: grid (token tiles of 64, d_ff splits, output-column groups).
// CTA (i, j, g) owns tokens [64i, 64i+64), a contiguous range of 128-wide
// d_ff steps (the last one 64 wide when F/64 is odd: TMA zero-fills the
// columns past F) and NCOL output columns: 384 at H=768, 256 at H=512 and
// 1024, all of H at 128 and 256.  Each column group recomputes its pre
// tiles, so H=768 does 1.5x the products of one group.  The reason is
// the register file: ptxas (CUDA 12.8) allocated the consumer path within
// the 168 registers a thread that 384 threads get at launch, setmaxnreg or
// not, and a 64 x 768 f32 accumulator over two warpgroups (192 a thread)
// spilled 2-3 KB and serialized the wgmma.  Three warpgroups:
//   - a producer (one thread) loads the x tile once by TMA (64 x H, kept
//     for the whole range) and streams W1 and W2 slabs through a ring of
//     NST stages of 32 x NCOL bf16 (24 KB at H=768, four stages), each
//     announced on an mbarrier: per step, W1 stages of KS1 rows x 128
//     columns (two 64-column atoms, MN-major, 128-byte swizzle), then W2
//     stages of 32 rows x NCOL columns.
//   - two consumers.  Consumer c computes pre for the step's columns
//     [64c, 64c + 64) (wgmma m64n64k16: A = the x tile, K-major; B = its
//     W1 atom), adds b1, applies the activation and dropout in registers
//     and writes bf16 h into a 64 x 128 tile in shared memory (K-major,
//     128-byte swizzle, double buffered); after a named barrier, each adds
//     h @ W2[step, its NCOL/2 columns] into its f32 accumulator (wgmma
//     m64nNk16, N = NCOL/2 <= 192: 96 registers).  Each stage's products
//     are one wgmma group; the consumer releases the previous stage once
//     all but the newest group are done, so the tensor pipe only drains
//     before h is formed.  Accumulators start at scale-d 0 (a register
//     written by any other instruction serializes wgmma), and the role
//     branch uses a warp-uniform warpgroup index (otherwise ptxas
//     serializes wgmma on a "divergent path").
// Shared memory at H=768: x 96 KB + 4 stages of 24 KB + h 2 x 16 KB =
// 225 KB.  One split: the CTA adds b2 and writes bf16 out.  More splits
// (few tokens): each CTA writes an f32 partial (T, H) to a workspace and
// ffn_fwd_reduce_kernel sums the splits in split order, adds b2 and
// casts: no float atomics, so the bits do not depend on scheduling.  The
// plan (ops/kernels/ffn.py::_fwd_plan) fills about one wave: T=16 takes
// 24 splits x 2 groups = 48 CTAs, T=512 8 x 8 x 2 = 128, T=16384 one
// split (512 CTAs).
// L2 traffic: a CTA streams the whole W1 and its W2 columns once: 288 KB
// a step at H=768, 3.5 GB a call at T=16384.  Neither the loads nor L2
// set the pace on the card: in a throwaway variant with 64-wide steps,
// taking out every TMA load barely changed the time, and taking out the
// products removed less than half of it; the rest is the per-step chain
// of waits, the h epilogue and the barrier, which the tensor pipe sits
// out (PERF.md, section 6).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ffn_common.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;
using namespace ffn;

namespace {

constexpr int BT = 64;          // token rows per CTA
constexpr int BF = 128;         // d_ff columns per step (the last may be 64)
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = 128 + CONSUMERS;
constexpr int SMEM_MAX = 232448;

// output columns a CTA owns: the largest multiple of 128 dividing H that
// is at most 384, so that a consumer's accumulator (64 x NCOL/2 f32) takes
// at most 96 registers a thread
__host__ __device__ constexpr int ncol_of(int h) {
  return h % 384 == 0 ? 384 : h % 256 == 0 ? 256 : 128;
}

template <int H>
struct Plan {
  static constexpr int NCOL = ncol_of(H);            // output columns a CTA owns
  static constexpr int NGROUP = H / NCOL;            // column groups in the grid
  static constexpr int WN = NCOL / 2;                // columns a consumer owns
  static constexpr int KS2 = 32;                     // W2 rows a stage holds
  static constexpr int NK2 = BF / KS2;               // W2 stages a step
  static constexpr int STAGE = KS2 * NCOL * 2;       // bytes of a ring stage
  static constexpr int KS1 = STAGE / (BF * 2);       // W1 rows a stage holds
  static constexpr int NK1 = H / KS1;                // W1 stages a step
  static constexpr int X_BYTES = BT * H * 2;
  static constexpr int H_BYTES = BT * BF * 2;
  static constexpr int NST_FIT =
      (SMEM_MAX - 1024 - X_BYTES - 2 * H_BYTES - 1024) / STAGE;
  static constexpr int NST = NST_FIT > 6 ? 6 : NST_FIT;
  static constexpr size_t X = 0;
  static constexpr size_t RING = X_BYTES;
  static constexpr size_t HB = RING + (size_t)NST * STAGE;
  static constexpr size_t BAR = HB + 2 * H_BYTES;
  static constexpr size_t BYTES = BAR + (2 * NST + 1) * 8 + 1024;  // + alignment
  static_assert(H % KS1 == 0 && KS1 % 16 == 0 && KS1 <= 256, "W1 stages");
  static_assert(NST >= 2, "the ring needs two stages");
  static_assert(BYTES <= SMEM_MAX, "shared memory");
};

template <int N>
__device__ __forceinline__ void mma_h_w2(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_n64<0, 1>(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_n128<0, 1>(d, da, db, scale_d);
  else wgmma_n192<0, 1>(d, da, db, scale_d);
}

template <int H, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w1,
               const __grid_constant__ CUtensorMap tm_w2,
               const bf16* __restrict__ b1, const bf16* __restrict__ b2,
               bf16* __restrict__ out, float* __restrict__ ws, int T, int F,
               int steps_per_split, uint32_t drop_thresh, float keep_prob,
               uint32_t seed, DropIdx drop_idx) {
  using P = Plan<H>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + P::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + P::NST;
  uint64_t* xbar = empty + P::NST;

  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int col0 = blockIdx.z * P::NCOL;
  const int s_begin = split * steps_per_split;
  const int s_end = min((F + BF - 1) / BF, s_begin + steps_per_split);

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init(xbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 0) {
    // ---- producer ----------------------------------------------------------
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w1);
      tma_prefetch_map(&tm_w2);
      mbar_expect_tx(xbar, P::X_BYTES);
      for (int b = 0; b < H / 64; ++b)
        tma_load_2d(smem + P::X + b * BT * 128, &tm_x, xbar, b * 64, t0);
      int stage = 0;
      uint32_t phase = 0;
      for (int s = s_begin; s < s_end; ++s) {
        const int f0 = s * BF;
        for (int k1 = 0; k1 < P::NK1; ++k1) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], P::STAGE);
          unsigned char* st = ring + stage * P::STAGE;
          for (int half = 0; half < 2; ++half)
            tma_load_2d(st + half * P::KS1 * 128, &tm_w1, &full[stage],
                        f0 + half * 64, k1 * P::KS1);
          if (++stage == P::NST) { stage = 0; phase ^= 1; }
        }
        for (int k2 = 0; k2 < P::NK2; ++k2) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], P::STAGE);
          unsigned char* st = ring + stage * P::STAGE;
          for (int a = 0; a < P::NCOL / 64; ++a)
            tma_load_2d(st + a * P::KS2 * 128, &tm_w2, &full[stage],
                        col0 + a * 64, f0 + k2 * P::KS2);
          if (++stage == P::NST) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    const int c = wg - 1;
    const int tw = threadIdx.x - 128 * wg;
    const int r0 = (tw / 32) * 16 + (tw % 32) / 4;  // rows r0 and r0 + 8
    const int cq = (tw % 4) * 2;  // column of the thread in each 8-column group
    // accumulators start from the first wgmma of their chain (scale-d 0):
    // a register written by any other instruction would serialize wgmma
    float acc[P::WN / 2];
    mbar_wait(xbar, 0);
    const uint64_t dx0 = desc(smem + P::X, 16, 1024, SW128);
    int stage = 0, pending = -1;
    uint32_t phase = 0;
    // Each stage's products are one wgmma group.  After committing it, the
    // consumer waits for all but that group and releases the stage the
    // previous group read, so the tensor cores never drain between stages
    // (only before h is formed).
    for (int s = s_begin; s < s_end; ++s) {
      const int f0 = s * BF;
      // pre[:, 64c : 64c + 64] = x @ W1[:, f0 + 64c : +64]
      float pre[32];
      for (int k1 = 0; k1 < P::NK1; ++k1) {
        mbar_wait(&full[stage], phase);
        const uint64_t dw = desc(ring + stage * P::STAGE + c * P::KS1 * 128,
                                 P::KS1 * 128, 1024, SW128);
        wgmma_fence();
#pragma unroll 4
        for (int kk = 0; kk < P::KS1 / 16; ++kk) {
          const int k = k1 * P::KS1 + kk * 16;
          wgmma_n64<0, 1>(pre, dx0 + (((k / 64) * BT * 128 + (k % 64) * 2) >> 4),
                          dw + ((kk * 2048) >> 4), k > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (pending >= 0) mbar_arrive(&empty[pending]);
        pending = stage;
        if (++stage == P::NST) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs<32>(pre);
      mbar_arrive(&empty[pending]);
      pending = -1;
      // bias, activation, dropout; bf16 h into the swizzled 64 x 128 tile
      unsigned char* hb = smem + P::HB + (s & 1) * P::H_BYTES;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = r0 + hr * 8;
          const int hc = c * 64 + j * 8 + cq;  // column in the h tile
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // columns past F (a last step of 64) read zero weights
            const int f = f0 + hc + e;
            const float bias = f < F ? __bfloat162float(b1[f]) : 0.f;
            float hv = act<ACT>(pre[j * 4 + hr * 2 + e] + bias);
            if (drop_thresh != 0u) {
              const bool keep =
                  keep_hash(seed, drop_idx.row((uint32_t)(t0 + row)),
                            (uint32_t)f + drop_idx.col0) >= drop_thresh;
              hv = keep ? hv / keep_prob : 0.f;
            }
            v[e] = hv;
          }
          *reinterpret_cast<__nv_bfloat162*>(
              hb + c * BT * 128 + row * 128 + (((j ^ (row % 8)) * 16) + cq * 2)) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
      fence_proxy_async();
      named_barrier(1, CONSUMERS);
      // acc += h @ W2[f0 : f0 + 128, this consumer's columns]; the last
      // group stays in flight into the next step's first pre group
      const uint64_t dh = desc(hb, 16, 1024, SW128);
      for (int k2 = 0; k2 < P::NK2; ++k2) {
        mbar_wait(&full[stage], phase);
        const uint64_t dw = desc(ring + stage * P::STAGE +
                                     c * (P::WN / 64) * P::KS2 * 128,
                                 P::KS2 * 128, 1024, SW128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < P::KS2 / 16; ++kk) {
          const int kh = k2 * P::KS2 + kk * 16;  // K in the h tile
          mma_h_w2<P::WN>(acc, dh + (((kh / 64) * BT * 128 + (kh % 64) * 2) >> 4),
                          dw + ((kk * 16 * 128) >> 4),
                          s > s_begin || k2 > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (pending >= 0) mbar_arrive(&empty[pending]);
        pending = stage;
        if (++stage == P::NST) { stage = 0; phase ^= 1; }
      }
    }
    wgmma_wait<0>();
    fence_regs<P::WN / 2>(acc);
    // epilogue: element i of the accumulator sits at row r0 (+8 for i%4 >= 2),
    // column (i/4)*8 + cq + i%2 of this consumer's columns
    const bool direct = gridDim.y == 1;
#pragma unroll
    for (int i = 0; i < P::WN / 2; i += 2) {
      const int t = t0 + r0 + ((i / 2) % 2) * 8;
      const int col = col0 + c * P::WN + (i / 4) * 8 + cq;
      if (t < T) {
        if (direct) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)t * H + col) =
              __floats2bfloat162_rn(acc[i] + __bfloat162float(b2[col]),
                                    acc[i + 1] + __bfloat162float(b2[col + 1]));
        } else {
          *reinterpret_cast<float2*>(ws + ((size_t)split * T + t) * H + col) =
              make_float2(acc[i], acc[i + 1]);
        }
      }
    }
  }
}

// out = bf16(sum over splits, in split order, + b2)
__global__ void ffn_fwd_reduce_kernel(const float* __restrict__ ws,
                                      int n_split, long long n, int H,
                                      const bf16* __restrict__ b2,
                                      bf16* __restrict__ out) {
  for (long long i = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
       i < n; i += 4 * (long long)gridDim.x * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(ws + i);
    for (int sp = 1; sp < n_split; ++sp) {
      const float4 v = *reinterpret_cast<const float4*>(ws + sp * n + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int col = (int)(i % H);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + i);
    o[0] = __floats2bfloat162_rn(s.x + __bfloat162float(b2[col]),
                                 s.y + __bfloat162float(b2[col + 1]));
    o[1] = __floats2bfloat162_rn(s.z + __bfloat162float(b2[col + 2]),
                                 s.w + __bfloat162float(b2[col + 3]));
  }
}

template <int H, int ACT>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, void* ws, int T,
                   int F, int n_split, uint32_t drop_thresh, float keep_prob,
                   uint32_t seed, DropIdx drop_idx, cudaStream_t stream) {
  using P = Plan<H>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ffn_fwd_kernel<H, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mx, m1, m2;
  if (!map_2d(&mx, x, T, H, H, BT, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&m1, w1, H, F, F, P::KS1, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&m2, w2, F, H, H, P::KS2, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const int n_steps = (F + BF - 1) / BF;
  const int per = (n_steps + n_split - 1) / n_split;
  const int splits = (n_steps + per - 1) / per;  // none of them empty
  dim3 grid((T + BT - 1) / BT, splits, P::NGROUP);
  ffn_fwd_kernel<H, ACT><<<grid, THREADS, P::BYTES, stream>>>(
      mx, m1, m2, static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), static_cast<float*>(ws), T, F, per,
      drop_thresh, keep_prob, seed, drop_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)T * H;
  const long long blocks = (n / 4 + 255) / 256;
  ffn_fwd_reduce_kernel<<<(int)(blocks < 2048 ? blocks : 2048), 256, 0,
                          stream>>>(static_cast<const float*>(ws), splits, n,
                                    H, static_cast<const bf16*>(b2),
                                    static_cast<bf16*>(out));
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_act(int act_id, const void* x, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* out, void* ws, int T, int F, int n_split,
                       uint32_t drop_thresh, float keep_prob, uint32_t seed,
                       DropIdx drop_idx, cudaStream_t s) {
  switch (act_id) {
    case ACT_GELU:
      return launch<H, ACT_GELU>(x, w1, b1, w2, b2, out, ws, T, F, n_split,
                                 drop_thresh, keep_prob, seed, drop_idx, s);
    case ACT_GELU_TANH:
      return launch<H, ACT_GELU_TANH>(x, w1, b1, w2, b2, out, ws, T, F,
                                      n_split, drop_thresh, keep_prob, seed,
                                      drop_idx, s);
    case ACT_RELU:
      return launch<H, ACT_RELU>(x, w1, b1, w2, b2, out, ws, T, F, n_split,
                                 drop_thresh, keep_prob, seed, drop_idx, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// act_id: 0 gelu (A-S erf), 1 gelu_tanh, 2 relu.  ws: n_split x T x H f32
// scratch, unused when n_split is 1.  One launch, or two with the reduce
// over splits.  drop_col0: the dropout hash takes d_ff column f as
// drop_col0 + f (a tensor-parallel rank's columns; 0 outside tensor
// parallelism); row_period / row_stride / row_offset: it takes token t as
// DropIdx::row(t) (a sequence-parallel rank's tokens; period 0 outside
// sequence parallelism).
int ffn_fwd_bf16(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, void* ws, int T,
                 int H, int F, int act_id, int n_split,
                 unsigned int drop_thresh, float keep_prob, unsigned int seed,
                 int drop_col0, int row_period, int row_stride,
                 int row_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropIdx drop_idx{(uint32_t)drop_col0, (uint32_t)row_period,
                         (uint32_t)row_stride, (uint32_t)row_offset};
  if (T < 1 || F < 64 || F % 64 != 0 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  switch (H) {
    case 128:
      return launch_act<128>(act_id, x, w1, b1, w2, b2, out, ws, T, F,
                             n_split, drop_thresh, keep_prob, seed,
                             drop_idx, s);
    case 256:
      return launch_act<256>(act_id, x, w1, b1, w2, b2, out, ws, T, F,
                             n_split, drop_thresh, keep_prob, seed,
                             drop_idx, s);
    case 512:
      return launch_act<512>(act_id, x, w1, b1, w2, b2, out, ws, T, F,
                             n_split, drop_thresh, keep_prob, seed,
                             drop_idx, s);
    case 768:
      return launch_act<768>(act_id, x, w1, b1, w2, b2, out, ws, T, F,
                             n_split, drop_thresh, keep_prob, seed,
                             drop_idx, s);
    case 1024:
      return launch_act<1024>(act_id, x, w1, b1, w2, b2, out, ws, T, F,
                              n_split, drop_thresh, keep_prob, seed,
                             drop_idx, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
