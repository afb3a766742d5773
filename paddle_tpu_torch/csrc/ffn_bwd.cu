// Fused transformer FFN backward for Hopper (sm_90a): bf16 in, f32
// accumulate.
//
// Replaces paddle_tpu/ops/pallas/ffn.py::_bwd_dw_kernel (:192) and
// ::_bwd_dx_kernel (:231), launched by _ffn_backward (pl.pallas_call at
// :272 and :306).  Both passes need the same element math, the TPU kernels
// recomputing the hidden tile from x instead of reading it back:
//
//   pre  = x @ W1[:, f] + b1                         (f32)
//   h    = keep(seed, t, f) ? act(pre) / (1 - p) : 0  (_ffn_keep hash)
//   dh   = keep ? (g @ W2[f, :]^T) / (1 - p) : 0
//   dpre = dh * act'(pre)
//   dW pass:  dW2[f, :] += bf16(h)^T g,  dW1[:, f] += x^T bf16(dpre),
//             db1[f] += sum_t dpre
//   dx pass:  dx += bf16(dpre) @ W1[:, f]^T
//
// x, g (T, H), W1 (H, F), b1 (F), W2 (F, H), all bf16 and contiguous;
// dx (T, H), dW1 (H, F), db1 (F), dW2 (F, H) come out in bf16, the
// weights' dtype, as in JAX.  db2 = sum g is a torch reduction in the
// wrapper, as in JAX.
//
// dx design: dpre is written once, then a plain GEMM.  Two launches:
//   1. ffn_bwd_dpre_kernel, one CTA per (128 d_ff columns, 128 tokens):
//      a producer warp streams 64-deep K slices of x, g (128 x 64 each,
//      K-major), W1 (64 x 128, MN-major, two 64-column atoms) and W2
//      (128 x 64, K-major) through a three-stage TMA ring (64 KB a stage);
//      two consumer warpgroups of 64 tokens each hold pre and dh as
//      wgmma m64n128k16 accumulators (128 f32 registers a thread), then
//      add b1, apply act', the dropout hash and scale, and store bf16 dpre
//      (T, F) to a workspace.
//   2. ffn_bwd_dx_kernel, one CTA per (128 d_model columns, 128 tokens):
//      dx = dpre @ W1^T, the W1 rows read K-major as they lie, K = F in
//      64-deep slices through a three-stage TMA ring (32 KB a stage),
//      wgmma m64n128k16 per consumer warpgroup, 99 KB of shared memory
//      and launch bounds for two CTAs an SM.
// In both grids the column tile varies fastest, so the CTAs in flight
// share a few token tiles and all the weights in L2 (with the token tile
// fastest, each wave read the whole 50 MB of x and g, or of dpre, from
// HBM again).  Three products and no recompute, against the five a
// column-grouped fused kernel would need at 168 registers a thread (its
// 64 x 768 f32 dx accumulator does not fit two warpgroups' registers,
// PERF.md section 6).
// The workspace costs 2 T F bytes written and read once (100.7 MB at
// T = 16384, F = 3072: ~0.06 ms of HBM); d_model is only a K or N extent,
// so any multiple of 128 up to 1024 runs.  Each consumer commits a stage's
// products as one wgmma group and releases the previous stage once all but
// that group are done, so the tensor pipe does not drain between stages.
//
// dW design: the TPU held (H, 512) and (512, H) f32 accumulators in VMEM
// (3 MB at H=768) over a sequential token axis.  Here a CTA owns a 16-wide
// d_ff slice and one of a few token splits, and its dW1 (H, 16) and dW2
// (16, H) slices stay in registers while it walks its split's 32-token
// tiles: wgmma m64n16k16 tiles with M over H, 2 x H/64 of them, half in
// each of two consumer warpgroups (96 registers a thread at H=768).  The
// 384 threads get 168 registers each at launch, and ptxas kept the
// consumers within that (setmaxnreg did not move it), which is what holds
// the slice at 16 columns.  A producer thread loads the W1 slice (H x 16,
// 32-byte swizzle, MN-major) and the W2 slice (16 x H, 128-byte swizzle,
// K-major) once, then x and g tiles by TMA into a ring: a tile is two
// stages of H/128 boxes, each box the tile's 32 x rows over its 32 g rows
// (rows past T arrive as zeros).  Per tile:
//   - recompute: consumer 0 multiplies the 64-row [x; g] boxes by the W1
//     slice (rows 0-31 are pre), consumer 1 by the W2 slice^T (rows 32-63
//     are dh): M=64 wgmma on 32 tokens, so half of each product is thrown
//     away, the price of a ring that fits beside the slices;
//   - the valid rows go to shared memory in f32; all 256 consumer threads
//     add b1, apply act, act' and dropout, sum db1 in registers and write
//     bf16 h and dpre as 32 x 16 tiles (32-byte swizzle, MN-major);
//   - each consumer adds x^T dpre and g^T h over its half of H: A is the
//     same x or g rows read M-major (transposed) from the box, B the tile.
// Each split writes f32 partials to a workspace and a second small kernel
// sums the splits in a fixed order and casts to bf16: no float atomics,
// so the result does not depend on scheduling.  At BERT-base shapes: 192
// slices x 2 splits = 384 CTAs (three nearly full waves), a 38 MB f32
// workspace, and 207 KB of shared memory (slices 48 KB, three 48 KB
// stages).  L2 traffic: every CTA reads its split's x and g, 192 x 50 MB
// = 9.7 GB a call; a throwaway variant in which a cluster of four slices
// shared each tile by TMA multicast cut that fourfold and ran slower on
// the card (the four CTAs wait on each other's stages), so the tiles are
// read per CTA.
//
// Bound on the H100: at BERT-base shapes (T = 16384, H = 768, F = 3072) the
// dW pass does 4 and the dx pass 3 products of 2*T*H*F flops (309 and
// 232 GFLOP) against ~60 MB of operands (dx: ~260 MB with its workspace):
// compute-bound, 0.313 and 0.234 ms at the bf16 tensor-core peak.  The dW
// kernel's steps run one after another within a tile (recompute,
// exchange, element math, products) and the n16 products read two operand
// bytes from shared memory for every 16 multiply-adds.  The dpre kernel's
// epilogue (act' and the hash on 128 x 128 elements) does not overlap its
// own main loop (one CTA an SM); the next CTA's loads do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ffn_common.cuh"
#include "hopper.cuh"

using namespace ffn;
using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 32;   // dW kernel: token rows per tile
constexpr int BFW = 16;  // dW kernel: d_ff columns per CTA (384 threads)

// ---- dx: dpre, then dx = dpre @ W1^T ------------------------------------------

constexpr int GM = 128;             // token rows a CTA owns (two warpgroups)
constexpr int GN = 128;             // output columns a CTA owns
constexpr int KS = 64;              // K slice a stage holds
constexpr int TILE = GM * KS * 2;   // bytes of a 128 x 64 bf16 box (16 KB)
constexpr int GTHREADS = 256 + 32;  // two consumer warpgroups + a producer warp
constexpr int DP_NST = 3;           // dpre ring: x, g, W1, W2 slices (64 KB)
constexpr int DX_NST = 3;           // dx ring: dpre, W1 slices (32 KB)

template <int NST, int STAGE>
struct Ring {
  static constexpr size_t BAR = (size_t)NST * STAGE;
  static constexpr size_t BYTES = BAR + 2 * NST * 8 + 1024;  // + alignment
  static_assert(BYTES <= 232448, "shared memory");
};
using DpRing = Ring<DP_NST, 4 * TILE>;
using DxRing = Ring<DX_NST, 2 * TILE>;

// dpre (T, F) bf16 for the tile (128 tokens from t0, 128 d_ff columns
// from f0): pre = x W1[:, f] and dh = g W2[f, :]^T over K = H, then the
// element math.  Stage layout: x (128 x 64, K-major), g (same), W1
// (64 x 128 as two 64-column MN-major atoms), W2 (128 x 64, K-major), all
// 128-byte swizzled.
template <int ACT>
__global__ void __launch_bounds__(GTHREADS, 1)
ffn_bwd_dpre_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_w1,
                    const __grid_constant__ CUtensorMap tm_w2,
                    const bf16* __restrict__ b1, bf16* __restrict__ dpre,
                    int T, int H, int F, uint32_t drop_thresh,
                    float inv_keep, uint32_t seed, uint32_t drop_col0) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DpRing::BAR);
  uint64_t* empty = full + DP_NST;
  const int f0 = blockIdx.x * GN, t0 = blockIdx.y * GM;
  const int nk = H / KS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < DP_NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {
    // ---- producer ------------------------------------------------------------
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 4 * TILE);
        unsigned char* st = smem + stage * 4 * TILE;
        tma_load_2d(st, &tm_x, &full[stage], k * KS, t0);
        tma_load_2d(st + TILE, &tm_g, &full[stage], k * KS, t0);
        tma_load_2d(st + 2 * TILE, &tm_w1, &full[stage], f0, k * KS);
        tma_load_2d(st + 2 * TILE + TILE / 2, &tm_w1, &full[stage], f0 + 64,
                    k * KS);
        tma_load_2d(st + 3 * TILE, &tm_w2, &full[stage], k * KS, f0);
        if (++stage == DP_NST) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---- consumers: tokens [t0 + 64c, t0 + 64c + 64) -------------------------
    const int c = wg;
    const int tw = threadIdx.x - 128 * c;
    const int r0 = (tw / 32) * 16 + (tw % 32) / 4;  // rows r0 and r0 + 8
    const int cq = (tw % 4) * 2;
    float pre[64], dh[64];
    int stage = 0, pending = -1;
    uint32_t phase = 0;
    for (int k = 0; k < nk; ++k) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = smem + stage * 4 * TILE;
      const uint64_t dx_ = desc(st + c * 64 * 128, 16, 1024, SW128);
      const uint64_t dg = desc(st + TILE + c * 64 * 128, 16, 1024, SW128);
      const uint64_t dw1 = desc(st + 2 * TILE, TILE / 2, 1024, SW128);
      const uint64_t dw2 = desc(st + 3 * TILE, 16, 1024, SW128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const int sc = k > 0 || kk > 0;
        wgmma_n128<0, 1>(pre, dx_ + ((kk * 32) >> 4), dw1 + ((kk * 2048) >> 4),
                         sc);
        wgmma_n128<0, 0>(dh, dg + ((kk * 32) >> 4), dw2 + ((kk * 32) >> 4), sc);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (pending >= 0 && tw % 32 == 0) mbar_arrive(&empty[pending]);
      pending = stage;
      if (++stage == DP_NST) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs<64>(pre);
    fence_regs<64>(dh);
    if (tw % 32 == 0) mbar_arrive(&empty[pending]);
    // element i sits at row r0 (+8 for i % 4 >= 2), column (i/4)*8 + cq +
    // i%2; the math runs unguarded (a column past F reads a zero bias) so
    // that the compiler can interleave the elements, and only the stores
    // are guarded
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int t = t0 + 64 * c + r0 + ((i / 2) % 2) * 8;
      const int f = f0 + (i / 4) * 8 + cq;
      const float2 bias =
          f < F ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + f))
                : make_float2(0.f, 0.f);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = pre[i + e] + (e ? bias.y : bias.x);
        float d = dh[i + e];
        if (drop_thresh != 0u) {
          const bool keep =
              keep_hash(seed, (uint32_t)t, (uint32_t)(f + e) + drop_col0) >=
              drop_thresh;
          d = keep ? d * inv_keep : 0.f;
        }
        v[e] = d * act_grad<ACT>(pv);
      }
      if (t < T && f < F)
        *reinterpret_cast<__nv_bfloat162*>(dpre + (size_t)t * F + f) =
            __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

// dx (T, H) = dpre (T, F) @ W1^T for the tile (128 tokens from t0, 128
// d_model columns from n0).  Stage layout: dpre (128 x 64, K-major), W1
// rows n0.. (128 x 64, K-major: the B operand as W1 lies), 128-byte
// swizzled.
__global__ void __launch_bounds__(GTHREADS, 2)
ffn_bwd_dx_kernel(const __grid_constant__ CUtensorMap tm_dp,
                  const __grid_constant__ CUtensorMap tm_w1,
                  bf16* __restrict__ dx, int T, int H, int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DxRing::BAR);
  uint64_t* empty = full + DX_NST;
  const int n0 = blockIdx.x * GN, t0 = blockIdx.y * GM;
  const int nk = F / KS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < DX_NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * TILE);
        unsigned char* st = smem + stage * 2 * TILE;
        tma_load_2d(st, &tm_dp, &full[stage], k * KS, t0);
        tma_load_2d(st + TILE, &tm_w1, &full[stage], k * KS, n0);
        if (++stage == DX_NST) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    const int c = wg;
    const int tw = threadIdx.x - 128 * c;
    const int r0 = (tw / 32) * 16 + (tw % 32) / 4;
    const int cq = (tw % 4) * 2;
    float acc[64];
    int stage = 0, pending = -1;
    uint32_t phase = 0;
    for (int k = 0; k < nk; ++k) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = smem + stage * 2 * TILE;
      const uint64_t da = desc(st + c * 64 * 128, 16, 1024, SW128);
      const uint64_t db = desc(st + TILE, 16, 1024, SW128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
        wgmma_n128<0, 0>(acc, da + ((kk * 32) >> 4), db + ((kk * 32) >> 4),
                         k > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (pending >= 0 && tw % 32 == 0) mbar_arrive(&empty[pending]);
      pending = stage;
      if (++stage == DX_NST) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs<64>(acc);
    if (tw % 32 == 0) mbar_arrive(&empty[pending]);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int t = t0 + 64 * c + r0 + ((i / 2) % 2) * 8;
      const int n = n0 + (i / 4) * 8 + cq;
      if (t < T)
        *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)t * H + n) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// ---- dW ----------------------------------------------------------------------

// A CTA owns the 16 d_ff columns [f0, f0 + 16) and one token split.
// Shared memory: the W1 slice (H x 16, 32-byte-swizzled MN-major: the B
// operand of pre), the W2 slice (16 x H, 128-byte-swizzled K-major: the B
// operand of dh), a ring of token-tile stages, the pre/dh exchange and the
// bf16 h and dpre tiles.  A 32-token tile is two stages; a stage holds
// CH = H/128 boxes of 64 H-columns, each box 64 rows of 128 bytes: the
// tile's 32 x rows, then its 32 g rows.
template <int H>
struct DwPlan {
  static constexpr int NBOX = H / 64;       // 64-column boxes of a tile
  static constexpr int CH = NBOX / 2;       // boxes a stage holds
  static constexpr int BOX = 64 * 128;      // 32 x rows + 32 g rows
  static constexpr int STAGE = CH * BOX;
  static constexpr int W1_BOX = H < 256 ? H : 256;  // TMA rows of the W1 slice
  static constexpr int W_BYTES = H * BFW * 2;       // each slice
  static constexpr int MISC = 2 * 32 * BFW * 4      // pre / dh exchange
                              + 4 * 32 * BFW * 2    // h, dpre, double buffered
                              + 256 * 4 + 1024;     // db1 reduce, barriers
  static constexpr int NST_FIT =
      (232448 - 1024 - 2 * W_BYTES - MISC) / STAGE;
  static constexpr int NST = NST_FIT > 4 ? 4 : NST_FIT;
  static constexpr int MT = NBOX / 2;       // 64-row M tiles of dW a consumer owns
  static constexpr size_t W1 = 0;
  static constexpr size_t W2 = W1 + W_BYTES;
  static constexpr size_t RING = W2 + W_BYTES;
  static constexpr size_t XP = RING + (size_t)NST * STAGE;  // f32 pre rows
  static constexpr size_t XD = XP + 32 * BFW * 4;           // f32 dh rows
  static constexpr size_t TH = XD + 32 * BFW * 4;           // bf16 h [2]
  static constexpr size_t TD = TH + 2 * 32 * BFW * 2;       // bf16 dpre [2]
  static constexpr size_t RED = TD + 2 * 32 * BFW * 2;      // db1 partials
  static constexpr size_t BAR = RED + 256 * 4;
  static constexpr size_t BYTES = BAR + (2 * NST + 1) * 8 + 1024;
  static_assert(NST >= 2, "the ring holds a whole tile");
  static_assert(BYTES <= 232448, "shared memory");
};

// element (t, n) of a 32 x 16 bf16 tile in the 32-byte-swizzled MN-major
// layout that the dW products read as their B operand
__device__ __forceinline__ int sw32(int t, int n) {
  return t * 32 + (((n >> 3) ^ ((t >> 2) & 1)) << 4) + (n & 7) * 2;
}

// grid (F / 16, n_split); split s sums token tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) into its own workspace
// row ws[s] = [dW1 (H, F) | dW2 (F, H) | db1 (F)] in f32
template <int H, int ACT>
__global__ void __launch_bounds__(384, 1)
ffn_bwd_dw_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_g,
                  const __grid_constant__ CUtensorMap tm_w1,
                  const __grid_constant__ CUtensorMap tm_w2,
                  const bf16* __restrict__ b1, float* __restrict__ ws, int T,
                  int F, int tiles_per_split, uint32_t drop_thresh,
                  float inv_keep, uint32_t seed, uint32_t drop_col0) {
  using P = DwPlan<H>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + P::RING;
  float* sP = reinterpret_cast<float*>(smem + P::XP);
  float* sD = reinterpret_cast<float*>(smem + P::XD);
  float* sRed = reinterpret_cast<float*>(smem + P::RED);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + P::NST;
  uint64_t* wbar = empty + P::NST;

  const int f0 = blockIdx.x * BFW;
  const int split = blockIdx.y;
  const int n_tiles = (T + BT - 1) / BT;
  const int i_begin = split * tiles_per_split;
  const int i_end = min(n_tiles, i_begin + tiles_per_split);

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // each consumer warp
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 0) {
    // ---- producer: the two weight slices once, then x/g tiles ------------
    if (threadIdx.x == 0) {
      mbar_expect_tx(wbar, 2 * P::W_BYTES);
      for (int r = 0; r < H; r += P::W1_BOX)
        tma_load_2d(smem + P::W1 + r * 32, &tm_w1, wbar, f0, r);
      for (int b = 0; b < P::NBOX; ++b)
        tma_load_2d(smem + P::W2 + b * BFW * 128, &tm_w2, wbar, b * 64, f0);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = i_begin; i < i_end; ++i) {
        for (int half = 0; half < 2; ++half) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], P::STAGE);
          unsigned char* st = ring + stage * P::STAGE;
          for (int b = 0; b < P::CH; ++b) {
            const int col = (half * P::CH + b) * 64;
            tma_load_2d(st + b * P::BOX, &tm_x, &full[stage], col, i * BT);
            tma_load_2d(st + b * P::BOX + 32 * 128, &tm_g, &full[stage], col,
                        i * BT);
          }
          if (++stage == P::NST) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    const int c = wg - 1;
    const int tc = threadIdx.x - 128;   // 0..255 over both consumers
    const int tw = tc % 128;
    const int r0 = (tw / 32) * 16 + (tw % 32) / 4;  // accumulator rows r0, r0 + 8
    const int cq = (tw % 4) * 2;
    // acc[m][0]: dW1[64 (c*MT + m) + row, f0 + col]; acc[m][1]: dW2[f0 + col,
    // 64 (c*MT + m) + row]
    float acc[P::MT][2][8];
    float db1_acc = 0.f;  // column tc % 16 of the tokens this thread visits
    mbar_wait(wbar, 0);
    const uint64_t dW1 = desc(smem + P::W1, 16, 256, SW32);
    const uint64_t dW2 = desc(smem + P::W2, 16, 1024, SW128);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = i_begin; i < i_end; ++i) {
      // the tile's two stages
      const int s0 = stage;
      const uint32_t p0 = phase;
      if (++stage == P::NST) { stage = 0; phase ^= 1; }
      const int s1 = stage;
      const uint32_t p1 = phase;
      if (++stage == P::NST) { stage = 0; phase ^= 1; }
      mbar_wait(&full[s0], p0);
      mbar_wait(&full[s1], p1);
      // recompute: rows 0-31 of [x; g] @ W1 slice are pre (consumer 0),
      // rows 32-63 of [x; g] @ W2 slice^T are dh (consumer 1)
      float rc[8];
      wgmma_fence();
#pragma unroll 4
      for (int k = 0; k < H; k += 16) {
        const int b = k / 64;
        const unsigned char* box = ring + (b < P::CH ? s0 : s1) * P::STAGE +
                                   (b % P::CH) * P::BOX + (k % 64) * 2;
        const uint64_t da = desc(box, 16, 1024, SW128);
        if (c == 0)
          wgmma_n16<0, 1>(rc, da, dW1 + ((k * 32) >> 4), k > 0);
        else
          wgmma_n16<0, 0>(rc, da, dW2 + ((b * BFW * 128 + (k % 64) * 2) >> 4),
                          k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<8>(rc);
      // the valid rows to the exchange: consumer 0 rows 0-31, 1 rows 32-63
      if ((tw / 32) / 2 == c) {
        float* dst = c == 0 ? sP : sD;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int row = r0 + ((e / 2) % 2) * 8 - 32 * c;
          dst[row * BFW + (e / 4) * 8 + cq + (e % 2)] = rc[e];
        }
      }
      named_barrier(1, 256);
      // bias, activation, dropout, act': bf16 h and dpre, two elements a thread
      unsigned char* th = smem + P::TH + (i & 1) * 32 * BFW * 2;
      unsigned char* td = smem + P::TD + (i & 1) * 32 * BFW * 2;
      const int n = tc % BFW;
      const float bias = __bfloat162float(b1[f0 + n]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = tc / BFW + 16 * e;
        const float pv = sP[t * BFW + n] + bias;
        float d = sD[t * BFW + n];
        float hv = act<ACT>(pv);
        if (drop_thresh != 0u) {
          const bool keep =
              keep_hash(seed, (uint32_t)(i * BT + t),
                        (uint32_t)(f0 + n) + drop_col0) >= drop_thresh;
          hv = keep ? hv * inv_keep : 0.f;
          d = keep ? d * inv_keep : 0.f;
        }
        const float dpre = d * act_grad<ACT>(pv);
        db1_acc += dpre;  // rows past T have x = g = 0, so dpre = 0
        *reinterpret_cast<bf16*>(th + sw32(t, n)) = __float2bfloat16(hv);
        *reinterpret_cast<bf16*>(td + sw32(t, n)) = __float2bfloat16(dpre);
      }
      fence_proxy_async();
      named_barrier(1, 256);
      // dW1[h, f] += x^T dpre and dW2[f, h]^T += g^T h over this consumer's
      // MT boxes of H; A = the x or g rows of the box read M-major
      const uint64_t dH = desc(th, 16, 256, SW32);
      const uint64_t dDP = desc(td, 16, 256, SW32);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < P::MT; ++m) {
        const int b = c * P::MT + m;
        const unsigned char* box =
            ring + (b < P::CH ? s0 : s1) * P::STAGE + (b % P::CH) * P::BOX;
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
          const int sc = i > i_begin || kk > 0;
          wgmma_n16<1, 1>(acc[m][0], desc(box + kk * 2048, 16, 1024, SW128),
                          dDP + ((kk * 512) >> 4), sc);
          wgmma_n16<1, 1>(acc[m][1],
                          desc(box + 32 * 128 + kk * 2048, 16, 1024, SW128),
                          dH + ((kk * 512) >> 4), sc);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (tw % 32 == 0) {
        mbar_arrive(&empty[s0]);
        mbar_arrive(&empty[s1]);
      }
    }
#pragma unroll
    for (int m = 0; m < P::MT; ++m) fence_regs<8>(acc[m][0]), fence_regs<8>(acc[m][1]);
    // this split's f32 partials, straight from the accumulators
    const long long HF = (long long)H * F;
    float* wd1 = ws + (long long)split * (2 * HF + F);
    float* wd2 = wd1 + HF;
#pragma unroll
    for (int m = 0; m < P::MT; ++m) {
      const int hb = 64 * (c * P::MT + m);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = hb + r0 + ((e / 2) % 2) * 8;
        const int f = f0 + (e / 4) * 8 + cq + (e % 2);
        wd1[(long long)h * F + f] = acc[m][0][e];
        wd2[(long long)f * H + h] = acc[m][1][e];
      }
    }
    sRed[tc] = db1_acc;
    named_barrier(1, 256);
    if (tc < BFW) {
      float s = 0.f;
      for (int j = tc; j < 256; j += BFW) s += sRed[j];
      wd1[2 * HF + f0 + tc] = s;
    }
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
  uint32_t drop_col0;  // the hash's first d_ff column (a tensor-parallel
                       // rank's; 0 outside tensor parallelism)
  cudaStream_t stream;
};

template <int ACT>
cudaError_t launch_dx(const Args& a, int H, bf16* dx, bf16* dpre) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ffn_bwd_dpre_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DpRing::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ffn_bwd_dx_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)DxRing::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap mx, mg, m1, m2, mdp, m1x;
  if (!map_2d(&mx, a.x, a.T, H, H, GM, KS, sw) ||
      !map_2d(&mg, a.g, a.T, H, H, GM, KS, sw) ||
      !map_2d(&m1, a.w1, H, a.F, a.F, KS, 64, sw) ||
      !map_2d(&m2, a.w2, a.F, H, H, GN, KS, sw) ||
      !map_2d(&mdp, dpre, a.T, a.F, a.F, GM, KS, sw) ||
      !map_2d(&m1x, a.w1, H, a.F, a.F, GN, KS, sw))
    return cudaErrorInvalidValue;
  const int mt = (a.T + GM - 1) / GM;
  ffn_bwd_dpre_kernel<ACT><<<dim3((a.F + GN - 1) / GN, mt), GTHREADS,
                             DpRing::BYTES, a.stream>>>(
      mx, mg, m1, m2, a.b1, dpre, a.T, H, a.F, a.drop_thresh, a.inv_keep,
      a.seed, a.drop_col0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn_bwd_dx_kernel<<<dim3(H / GN, mt), GTHREADS, DxRing::BYTES, a.stream>>>(
      mdp, m1x, dx, a.T, H, a.F);
  return cudaGetLastError();
}

template <int H, int ACT>
cudaError_t launch_dw(const Args& a, bf16* dw1, bf16* db1, bf16* dw2,
                      float* ws, int n_split) {
  using P = DwPlan<H>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ffn_bwd_dw_kernel<H, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mx, mg, m1, m2;
  if (!hopper::map_2d(&mx, a.x, a.T, H, H, BT, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::map_2d(&mg, a.g, a.T, H, H, BT, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::map_2d(&m1, a.w1, H, a.F, a.F, P::W1_BOX, BFW,
                      CU_TENSOR_MAP_SWIZZLE_32B) ||
      !hopper::map_2d(&m2, a.w2, a.F, H, H, BFW, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const int n_tiles = (a.T + BT - 1) / BT;
  const int per_split = (n_tiles + n_split - 1) / n_split;
  const int splits = (n_tiles + per_split - 1) / per_split;  // none empty
  dim3 grid(a.F / BFW, splits);
  ffn_bwd_dw_kernel<H, ACT><<<grid, 384, P::BYTES, a.stream>>>(
      mx, mg, m1, m2, a.b1, ws, a.T, a.F, per_split, a.drop_thresh,
      a.inv_keep, a.seed, a.drop_col0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long HF = (long long)H * a.F;
  const long long n = 2 * HF + a.F;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ffn_dw_reduce_kernel<<<blocks, 256, 0, a.stream>>>(ws, splits, HF, a.F,
                                                     dw1, dw2, db1);
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch_dw(int act_id, const Args& a, bf16* dw1, bf16* db1,
                        bf16* dw2, float* ws, int n_split) {
  switch (act_id) {
    case ACT_GELU:
      return launch_dw<H, ACT_GELU>(a, dw1, db1, dw2, ws, n_split);
    case ACT_GELU_TANH:
      return launch_dw<H, ACT_GELU_TANH>(a, dw1, db1, dw2, ws, n_split);
    case ACT_RELU:
      return launch_dw<H, ACT_RELU>(a, dw1, db1, dw2, ws, n_split);
    default:
      return cudaErrorInvalidValue;
  }
}

Args make_args(const void* x, const void* g, const void* w1, const void* b1,
               const void* w2, int T, int F, unsigned int drop_thresh,
               float inv_keep, unsigned int seed, int drop_col0,
               void* stream) {
  return Args{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
              static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
              static_cast<const bf16*>(w2), T, F, drop_thresh, inv_keep,
              seed, (uint32_t)drop_col0, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// act_id: 0 gelu (A-S erf), 1 gelu_tanh, 2 relu; inv_keep = 1 / (1 - p);
// drop_col0: the dropout hash takes d_ff column f as drop_col0 + f.
// ws: n_split x (2*H*F + F) f32 scratch.  Two launches: the dW pass and
// the reduce over splits.
int ffn_bwd_dw_bf16(const void* x, const void* g, const void* w1,
                    const void* b1, const void* w2, void* dw1, void* db1,
                    void* dw2, void* ws, int T, int H, int F, int act_id,
                    int n_split, unsigned int drop_thresh, float inv_keep,
                    unsigned int seed, int drop_col0, void* stream) {
  if (T < 1 || n_split < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, g, w1, b1, w2, T, F, drop_thresh, inv_keep,
                           seed, drop_col0, stream);
  bf16 *d1 = static_cast<bf16*>(dw1), *d2 = static_cast<bf16*>(dw2);
  bf16* db = static_cast<bf16*>(db1);
  float* w = static_cast<float*>(ws);
  switch (H) {
    case 128: return (int)dispatch_dw<128>(act_id, a, d1, db, d2, w, n_split);
    case 256: return (int)dispatch_dw<256>(act_id, a, d1, db, d2, w, n_split);
    case 512: return (int)dispatch_dw<512>(act_id, a, d1, db, d2, w, n_split);
    case 768: return (int)dispatch_dw<768>(act_id, a, d1, db, d2, w, n_split);
    case 1024: return (int)dispatch_dw<1024>(act_id, a, d1, db, d2, w, n_split);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dpre: T x F bf16 scratch.  Two launches: dpre, then dx = dpre @ W1^T.
// H a multiple of 128 up to 1024, F a multiple of 64.
int ffn_bwd_dx_bf16(const void* x, const void* g, const void* w1,
                    const void* b1, const void* w2, void* dx, void* dpre,
                    int T, int H, int F, int act_id,
                    unsigned int drop_thresh, float inv_keep,
                    unsigned int seed, int drop_col0, void* stream) {
  if (T < 1 || H < GN || H > 1024 || H % GN != 0 || F < KS || F % KS != 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, g, w1, b1, w2, T, F, drop_thresh, inv_keep,
                           seed, drop_col0, stream);
  bf16* o = static_cast<bf16*>(dx);
  bf16* dp = static_cast<bf16*>(dpre);
  switch (act_id) {
    case ACT_GELU: return (int)launch_dx<ACT_GELU>(a, H, o, dp);
    case ACT_GELU_TANH: return (int)launch_dx<ACT_GELU_TANH>(a, H, o, dp);
    case ACT_RELU: return (int)launch_dx<ACT_RELU>(a, H, o, dp);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
