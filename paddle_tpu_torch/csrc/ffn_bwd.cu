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
// 232 GFLOP) against ~60 MB of operands: compute-bound, 0.313 and 0.234 ms
// at the bf16 tensor-core peak.  The dW kernel's steps run one after
// another within a tile (recompute, exchange, element math, products) and
// the n16 products read two operand bytes from shared memory for every
// 16 multiply-adds; the dx kernel still runs WMMA without overlapping
// loads.  Both are far from the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "ffn_common.cuh"
#include "hopper.cuh"

using namespace nvcuda;
using namespace ffn;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 32;   // token rows per tile (both kernels)
constexpr int BF = 64;   // dx kernel: d_ff columns per step
constexpr int BFW = 16;  // dW kernel: d_ff columns per CTA (384 threads)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
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
                  float inv_keep, uint32_t seed) {
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
          const bool keep = keep_hash(seed, (uint32_t)(i * BT + t),
                                      (uint32_t)(f0 + n)) >= drop_thresh;
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
      a.inv_keep, a.seed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long HF = (long long)H * a.F;
  const long long n = 2 * HF + a.F;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ffn_dw_reduce_kernel<<<blocks, 256, 0, a.stream>>>(ws, splits, HF, a.F,
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
  if (T < 1 || n_split < 1) return (int)cudaErrorInvalidValue;
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
