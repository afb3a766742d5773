// Flash-attention backward for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_bwd_dkv_kernel (:263)
// and ::_flash_bwd_dq_kernel (:331) (launched by _flash_backward,
// pl.pallas_call at :424 and :438).  From the forward's saved lse and
// delta = rowsum(g * o) (a torch reduction in the wrapper, as in JAX) they
// recompute, per (query tile, key tile):
//
//   s   = (q k^T) * scale + kbias[b, k];  DEFAULT_MASK_VALUE where causal
//         and q + causal_offset < k                          (f32)
//   p   = exp(s - lse[q])
//   p~  = keep(seed, bh, q, k) ? p / (1 - p_drop) : 0        (_keep_mask3)
//   dp  = keep ? (g v^T) / (1 - p_drop) : 0
//   ds  = p * (dp - delta[q]) * scale
//   dkv pass:  dV += bf16(p~)^T g,  dK += bf16(ds)^T q
//   dq pass:   dQ += bf16(ds) k
//
// Layout: q/g (B, Sq, H, D), k/v (B, Sk, H, D) read in place by strides
// (the last dim contiguous, the others nesting multiples of 8 elements);
// lse and delta (B*H, Sq) f32 rows with a row stride that is a multiple
// of 4; dq (B, Sq, H, D), dk/dv (B, Sk, H, D) contiguous bf16.  Ragged Sq
// and Sk edges are masked here.  D in {16, 32, 64, 128}.
//
// Design: both passes are the forward kernel's shape (flash_fwd.cu), built
// from the pieces of flash_common.cuh.  A CTA is NC = 1 or 2 warpgroups
// of 64 rows, with no producer warp; the wrapper's plan picks NC as the
// forward's plan does.
//   dq:  one CTA per (batch*head, 64 or 128 queries).  Q and G come by TMA
//        once; K and V tiles of 64 keys with their key biases stream
//        through a ring of NST stages (4-D and 2-D tensor maps, as in the
//        forward).  Per key tile: S = Q K^T and dP = G V^T by wgmma with
//        both operands in shared memory (K and V share one K-major
//        layout); p, the dropout hash and dS in registers, two rows of 16
//        columns a thread, with lse and delta of those rows held in
//        registers all along; dS becomes bf16 in place and dQ += dS K runs
//        as register-A wgmma with K read MN-major: the forward's O += P V
//        with K in V's place.  The key tiles the forward skipped above the
//        causal diagonal are skipped by the same loop bound.
//   dkv: one CTA per (batch*head, 64 or 128 keys).  K and V come by TMA
//        once; Q and G tiles of 64 queries stream through the ring with
//        their 64 lse and delta values (2-D maps over the (B*H, Sq) rows).
//        Per query tile: S^T = K Q^T and dP^T = V G^T, both K-major; in
//        registers, with queries as the columns, p~^T and dS^T become
//        register A; dV += p~^T G and dK += dS^T Q read G and Q MN-major,
//        so one shared-memory tile serves both of its products.  Causal:
//        query tiles wholly above the diagonal of every key of the CTA
//        (whose first query keeps key 0) are skipped, so the loop runs
//        over the tiles before and after that range.
// Every product is unconditional; masking is a register select on the
// causal diagonal and on the ragged last tile (columns past Sk in dq, past
// Sq in dkv, which would otherwise add to the products over them).  Each
// CTA writes its own rows (no atomics), so a run gives the same bits
// every time.
//
// Bound on the H100: at BERT-base (B=32, S=512, 12 heads of 64) the dkv
// pass does 4 products of 2 B H S^2 D flops (51.5 GFLOP) against ~150 MB,
// the dq pass 3 (38.7 GFLOP) against ~126 MB: 0.052 and 0.039 ms of
// tensor cores.  As in the forward, the element work on the 100.7 M
// scores (an ex2, some fifteen FP32 instructions and, with dropout, the
// hash's ~15 integer ones) costs more than the products; it stays in
// registers, with no score or probability tile in shared memory.

#include <string.h>

#include "flash_common.cuh"

using namespace flash;

namespace {

// shared memory of a dq CTA: its Q and G rows, then the K, V and
// key-bias stages
template <int D>
struct DqSmem : Geom<D> {
  using G = Geom<D>;
  static constexpr size_t Q = 0;
  static constexpr size_t GR = Q + (size_t)G::NATOM * G::RES;
  static constexpr size_t K = GR + (size_t)G::NATOM * G::RES;
  static constexpr size_t V = K + (size_t)NST * G::TILE;
  static constexpr size_t BIAS = V + (size_t)NST * G::TILE;
  static constexpr size_t BAR = BIAS + (size_t)NST * BK * 4;
  static constexpr size_t BYTES = BAR + (NST + 1) * 8 + NST * 4 + 1024;  // + alignment
};

// shared memory of a dkv CTA: its K and V rows, then the Q, G, lse and
// delta stages
template <int D>
struct DkvSmem : Geom<D> {
  using G = Geom<D>;
  static constexpr size_t K = 0;
  static constexpr size_t V = K + (size_t)G::NATOM * G::RES;
  static constexpr size_t Q = V + (size_t)G::NATOM * G::RES;
  static constexpr size_t GT = Q + (size_t)NST * G::TILE;
  static constexpr size_t LSE = GT + (size_t)NST * G::TILE;
  static constexpr size_t DELTA = LSE + (size_t)NST * BK * 4;
  static constexpr size_t BAR = DELTA + (size_t)NST * BK * 4;
  static constexpr size_t BYTES = BAR + (NST + 1) * 8 + NST * 4 + 1024;  // + alignment
};

static_assert(DqSmem<128>::BYTES <= 232448 && DkvSmem<128>::BYTES <= 232448,
              "a CTA's shared memory");

// A thread's share of one 64 x 64 tile of either pass: rows r0 and r0 + 8
// of the S and dP accumulators (absolute rows row0, row0 + 8), columns
// c0 + 8j + cq + {0, 1}.  In the dq pass (KEY_ROWS false) rows are
// queries and columns keys; in the dkv pass the other way round.  S and
// dP are turned in place into p~ (in s, read by the dkv pass only) and dS
// (in dp).  Row-side values come in registers (rl/rd: lse and delta of
// the two query rows; rb: the bias of the two key rows), column-side
// ones from the stage in shared memory (cb: key biases or null; cl/cd:
// lse and delta of the query columns).  `diag`: the tile crosses the
// causal diagonal; `edge`: it holds columns past col_limit (Sk or Sq),
// whose p~ and dS are set to 0.
struct GradTile {
  int row0, cq, col_limit, causal_offset;
  float scale, inv_keep;
  uint32_t drop_thresh, seed, bh;

  template <bool KEY_ROWS, bool DROP>
  __device__ __forceinline__ void run(float* s, float* dp, int c0, bool diag,
                                      bool edge, const float* rl,
                                      const float* rd, const float* rb,
                                      const float* cb, const float* cl,
                                      const float* cd) const {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        const int ca = c0 + col;  // absolute column
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          const int ra = row0 + 8 * i;  // absolute row
          const int qa = KEY_ROWS ? ca : ra, ka = KEY_ROWS ? ra : ca;
          const float bias = KEY_ROWS ? rb[i] : cb != nullptr ? cb[col] : 0.f;
          const float l = KEY_ROWS ? cl[col] : rl[i];
          const float dl = KEY_ROWS ? cd[col] : rd[i];
          float v = fmaf(s[idx], scale, bias);
          if (diag && qa + causal_offset < ka) v = MASK_VALUE;
          const float p = ex2((v - l) * LOG2E);
          float pt = p, d = dp[idx];
          if constexpr (DROP) {
            const bool keep = keep_hash(seed, bh, (uint32_t)qa, (uint32_t)ka) >=
                              drop_thresh;
            pt = keep ? p * inv_keep : 0.f;
            d = keep ? d * inv_keep : 0.f;
          }
          float ds = p * (d - dl) * scale;
          if (edge && ca >= col_limit) pt = ds = 0.f;
          s[idx] = pt;
          dp[idx] = ds;
        }
      }
    }
  }
};

__device__ __forceinline__ int ceil_div_pos(int x, int y) {
  return x <= 0 ? 0 : (x + y - 1) / y;
}

template <int D, bool DROP>
__global__ void __launch_bounds__(MAX_NC * 128, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_bias, int has_bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int rows_ld,
                    bf16* __restrict__ dq, int H, int Sq, int Sk, int causal,
                    int causal_offset, float scale, uint32_t drop_thresh,
                    float inv_keep, uint32_t seed, int HT, int HO) {
  using T = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sbias = reinterpret_cast<float*>(smem + T::BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR);
  uint64_t* rbar = full + NST;                         // Q and G
  int* released = reinterpret_cast<int*>(rbar + 1);  // warps done, by stage

  const int nc = blockDim.x / 128;  // warpgroups
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * nc * BM;
  int n_kt = (Sk + BK - 1) / BK;
  // the forward's skip: every row of the CTA keeps key 0, so key tiles
  // wholly above the diagonal had p == 0 there
  if (causal && q0 + causal_offset >= 0)
    n_kt = min(n_kt, (q0 + nc * BM - 1 + causal_offset) / BK + 1);

  // K, V and the key biases of tile kt into stage st, announced on full[st]
  auto fill = [&](int st, int kt) {
    mbar_expect_tx(&full[st], 2 * T::TILE + (has_bias ? BK * 4 : 0));
    for (int a = 0; a < T::NATOM; ++a) {
      tma_load_4d(smem + T::K + st * T::TILE + a * BK * T::ROWB, &tm_k,
                  &full[st], a * T::ATOM, h, kt * BK, b);
      tma_load_4d(smem + T::V + st * T::TILE + a * BK * T::ROWB, &tm_v,
                  &full[st], a * T::ATOM, h, kt * BK, b);
    }
    if (has_bias) tma_load_2d(sbias + st * BK, &tm_bias, &full[st], kt * BK, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_init(rbar, 1);
    fence_barrier_init();
    mbar_expect_tx(rbar, 2 * nc * BM * D * 2);
    for (int a = 0; a < T::NATOM; ++a) {
      tma_load_4d(smem + T::Q + a * T::RES, &tm_q, rbar, a * T::ATOM, h, q0, b);
      tma_load_4d(smem + T::GR + a * T::RES, &tm_g, rbar, a * T::ATOM, h, q0,
                  b);
    }
    for (int i = 0; i < NST && i < n_kt; ++i) fill(i, i);
  }
  __syncthreads();

  const int c = warpgroup_index();
  const int tw = threadIdx.x - 128 * c;
  const int lane = tw % 32;
  const int r0 = (tw / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of 64
  const int cq = (lane % 4) * 2;             // column in each 8-column group
  const int row0 = q0 + c * BM + r0;         // absolute query rows
  unsigned char* sq = smem + T::Q + c * BM * T::ROWB;
  unsigned char* sg = smem + T::GR + c * BM * T::ROWB;
  // lse and delta of the thread's two rows (0 past Sq: those rows of dQ
  // are not written, and the products keep rows apart)
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row0 + 8 * i < Sq;
    rl[i] = in ? lse[(long long)bh * rows_ld + row0 + 8 * i] : 0.f;
    rd[i] = in ? delta[(long long)bh * rows_ld + row0 + 8 * i] : 0.f;
  }
  const GradTile gt{row0, cq, Sk, causal_offset, scale, inv_keep,
                    drop_thresh, seed, (uint32_t)(b * HT + HO + h)};

  float dqa[D / 2];   // dQ: rows r0, r0 + 8 as an f32 accumulator
  float s[BK / 2];    // S of one key tile, then p~ (unread here)
  float dp[BK / 2];   // dP of the tile, then dS
  uint32_t dsa[BK / 16][4];  // bf16 dS as register A
  mbar_wait(rbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    unsigned char* sk = smem + T::K + stage * T::TILE;
    mbar_wait(&full[stage], phase);
    wgmma_fence();
    mma_rows_tile_t<D>(s, sq, sk);
    mma_rows_tile_t<D>(dp, sg, smem + T::V + stage * T::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
    fence_regs<BK / 2>(dp);
    gt.run<false, DROP>(s, dp, k0,
                        causal && k0 + BK - 1 > q0 + c * BM + causal_offset,
                        k0 + BK > Sk, rl, rd, nullptr,
                        has_bias ? sbias + stage * BK : nullptr, nullptr,
                        nullptr);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) acc_to_a(dsa[j], dp, j);
    wgmma_fence();
    mma_regs_tile<D>(dqa, dsa, sk, kt > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dqa);
    // the stage of tile kt is done: the last warp refills it with tile
    // kt + NST
    release_stage(&released[stage], nc * 4, lane, [&]() {
      if (kt + NST < n_kt) fill(stage, kt + NST);
    });
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }

  // epilogue: bf16 dQ through the warpgroup's Q rows
  stage_acc<D>(sq, dqa, r0, cq, 1.f, 1.f);
  named_barrier(1 + c, 128);
  store_rows<D>(sq, dq, b, h, H, Sq, q0 + c * BM, tw);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(MAX_NC * 128, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta,
                     const float* __restrict__ kbias, int bias_ld,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                     int Sq, int Sk, int causal, int causal_offset,
                     float scale, uint32_t drop_thresh, float inv_keep,
                     uint32_t seed, int HT, int HO) {
  using T = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* slse = reinterpret_cast<float*>(smem + T::LSE);
  float* sdelta = reinterpret_cast<float*>(smem + T::DELTA);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR);
  uint64_t* rbar = full + NST;                         // K and V
  int* released = reinterpret_cast<int*>(rbar + 1);  // warps done, by stage

  const int nc = blockDim.x / 128;  // warpgroups
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * nc * BM;
  const int n_qt = (Sq + BK - 1) / BK;
  // query tiles: [0, n_lead) and [first, n_qt).  Causal: the tiles whose
  // first query keeps no key (q0 + offset < 0) lead; after them, tiles
  // wholly above the diagonal of every key of the CTA add p == 0 and are
  // skipped
  int n_lead = n_qt, first = n_qt;
  if (causal) {
    n_lead = min(n_qt, ceil_div_pos(-causal_offset, BK));
    first = max(n_lead,
                min(n_qt, ceil_div_pos(k0 - (BK - 1) - causal_offset, BK)));
  }
  const int n_tiles = n_lead + n_qt - first;
  if (n_tiles == 0) {  // no query sees these keys: dK = dV = 0
    constexpr int CH = D / 8;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < nc * BM * CH; i += blockDim.x) {
      const int key = k0 + i / CH;
      if (key < Sk) {
        const long long at =
            (((long long)b * Sk + key) * H + h) * D + (i % CH) * 8;
        *reinterpret_cast<uint4*>(dk + at) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv + at) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  auto tile = [&](int i) { return i < n_lead ? i : i - n_lead + first; };

  // Q, G, lse and delta of the i-th query tile into stage st
  auto fill = [&](int st, int i) {
    const int q0 = tile(i) * BK;
    mbar_expect_tx(&full[st], 2 * T::TILE + 2 * BK * 4);
    for (int a = 0; a < T::NATOM; ++a) {
      tma_load_4d(smem + T::Q + st * T::TILE + a * BK * T::ROWB, &tm_q,
                  &full[st], a * T::ATOM, h, q0, b);
      tma_load_4d(smem + T::GT + st * T::TILE + a * BK * T::ROWB, &tm_g,
                  &full[st], a * T::ATOM, h, q0, b);
    }
    tma_load_2d(slse + st * BK, &tm_lse, &full[st], q0, bh);
    tma_load_2d(sdelta + st * BK, &tm_delta, &full[st], q0, bh);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_init(rbar, 1);
    fence_barrier_init();
    mbar_expect_tx(rbar, 2 * nc * BM * D * 2);
    for (int a = 0; a < T::NATOM; ++a) {
      tma_load_4d(smem + T::K + a * T::RES, &tm_k, rbar, a * T::ATOM, h, k0, b);
      tma_load_4d(smem + T::V + a * T::RES, &tm_v, rbar, a * T::ATOM, h, k0, b);
    }
    for (int i = 0; i < NST && i < n_tiles; ++i) fill(i, i);
  }
  __syncthreads();

  const int c = warpgroup_index();
  const int tw = threadIdx.x - 128 * c;
  const int lane = tw % 32;
  const int r0 = (tw / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of 64
  const int cq = (lane % 4) * 2;             // column in each 8-column group
  const int row0 = k0 + c * BM + r0;         // absolute key rows
  unsigned char* sk = smem + T::K + c * BM * T::ROWB;
  unsigned char* sv = smem + T::V + c * BM * T::ROWB;
  // the key biases of the thread's two rows (0 past Sk: those rows of dK
  // and dV are not written)
  float rb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    rb[i] = kbias != nullptr && row0 + 8 * i < Sk
                ? kbias[(long long)b * bias_ld + row0 + 8 * i] : 0.f;
  const GradTile gt{row0, cq, Sq, causal_offset, scale, inv_keep,
                    drop_thresh, seed, (uint32_t)(b * HT + HO + h)};

  float dka[D / 2], dva[D / 2];  // dK, dV: rows r0, r0 + 8, f32
  float s[BK / 2];               // S^T of one query tile, then p~^T
  float dp[BK / 2];              // dP^T, then dS^T
  uint32_t pa[BK / 16][4], dsa[BK / 16][4];  // bf16 p~^T, dS^T as register A
  mbar_wait(rbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = tile(i) * BK;
    unsigned char* stq = smem + T::Q + stage * T::TILE;
    unsigned char* stg = smem + T::GT + stage * T::TILE;
    mbar_wait(&full[stage], phase);
    wgmma_fence();
    mma_rows_tile_t<D>(s, sk, stq);
    mma_rows_tile_t<D>(dp, sv, stg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
    fence_regs<BK / 2>(dp);
    gt.run<true, DROP>(s, dp, q0,
                       causal && q0 + causal_offset < k0 + c * BM + BM - 1,
                       q0 + BK > Sq, nullptr, nullptr, rb, nullptr,
                       slse + stage * BK, sdelta + stage * BK);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      acc_to_a(pa[j], s, j);
      acc_to_a(dsa[j], dp, j);
    }
    wgmma_fence();
    mma_regs_tile<D>(dva, pa, stg, i > 0);
    mma_regs_tile<D>(dka, dsa, stq, i > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dva);
    fence_regs<D / 2>(dka);
    release_stage(&released[stage], nc * 4, lane, [&]() {
      if (i + NST < n_tiles) fill(stage, i + NST);
    });
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }

  // epilogue: bf16 dK and dV through the warpgroup's K and V rows
  stage_acc<D>(sk, dka, r0, cq, 1.f, 1.f);
  stage_acc<D>(sv, dva, r0, cq, 1.f, 1.f);
  named_barrier(1 + c, 128);
  store_rows<D>(sk, dk, b, h, H, Sk, k0 + c * BM, tw);
  store_rows<D>(sv, dv, b, h, H, Sk, k0 + c * BM, tw);
}

struct Args {
  const void *q, *k, *v, *g;
  const float* kbias;
  int bias_ld;
  const float *lse, *delta;
  int rows_ld, B, H, Sq, Sk;
  const long long* st;  // q, k, v, g: (batch, seq, head) strides each
  int block, causal, causal_offset;
  float scale;
  uint32_t drop_thresh;
  float inv_keep;
  uint32_t seed;
  int HT, HO;  // the dropout hash's batch-head: b * HT + HO + h
  cudaStream_t stream;
};

template <class Kernel>
cudaError_t configure(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <int D, bool DROP>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  const int nc = a.block / BM;
  CUtensorMap maps[5];
  memset(&maps[4], 0, sizeof(CUtensorMap));  // unread without a bias
  if (!map_bshd<D>(&maps[0], a.q, a.B, a.Sq, a.H, a.st, a.block) ||
      !map_bshd<D>(&maps[1], a.g, a.B, a.Sq, a.H, a.st + 9, a.block) ||
      !map_bshd<D>(&maps[2], a.k, a.B, a.Sk, a.H, a.st + 3, BK) ||
      !map_bshd<D>(&maps[3], a.v, a.B, a.Sk, a.H, a.st + 6, BK) ||
      (a.kbias != nullptr &&
       !map_2d(&maps[4], a.kbias, a.B, a.Sk, a.bias_ld, 1, BK,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)))
    return cudaErrorInvalidValue;
  const size_t bytes = DqSmem<D>::BYTES;
  static bool configured = false;
  cudaError_t err = configure(flash_bwd_dq_kernel<D, DROP>, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + a.block - 1) / a.block, a.B * a.H);
  flash_bwd_dq_kernel<D, DROP><<<grid, nc * 128, bytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a.kbias != nullptr, a.lse,
      a.delta, a.rows_ld, dq, a.H, a.Sq, a.Sk, a.causal, a.causal_offset,
      a.scale, a.drop_thresh, a.inv_keep, a.seed, a.HT, a.HO);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv(const Args& a, bf16* dk, bf16* dv) {
  const int nc = a.block / BM;
  CUtensorMap maps[6];
  if (!map_bshd<D>(&maps[0], a.k, a.B, a.Sk, a.H, a.st + 3, a.block) ||
      !map_bshd<D>(&maps[1], a.v, a.B, a.Sk, a.H, a.st + 6, a.block) ||
      !map_bshd<D>(&maps[2], a.q, a.B, a.Sq, a.H, a.st, BK) ||
      !map_bshd<D>(&maps[3], a.g, a.B, a.Sq, a.H, a.st + 9, BK) ||
      !map_2d(&maps[4], a.lse, (uint64_t)a.B * a.H, a.Sq, a.rows_ld, 1, BK,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !map_2d(&maps[5], a.delta, (uint64_t)a.B * a.H, a.Sq, a.rows_ld, 1, BK,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  const size_t bytes = DkvSmem<D>::BYTES;
  static bool configured = false;
  cudaError_t err = configure(flash_bwd_dkv_kernel<D, DROP>, bytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + a.block - 1) / a.block, a.B * a.H);
  flash_bwd_dkv_kernel<D, DROP><<<grid, nc * 128, bytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.kbias,
      a.bias_ld, dk, dv, a.H, a.Sq, a.Sk, a.causal, a.causal_offset, a.scale,
      a.drop_thresh, a.inv_keep, a.seed, a.HT, a.HO);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(const Args& a, bf16* dq, bf16* dk, bf16* dv) {
  if (dq != nullptr)
    return a.drop_thresh != 0u ? launch_dq<D, true>(a, dq)
                               : launch_dq<D, false>(a, dq);
  return a.drop_thresh != 0u ? launch_dkv<D, true>(a, dk, dv)
                             : launch_dkv<D, false>(a, dk, dv);
}

int dispatch(const Args& a, int D, bf16* dq, bf16* dk, bf16* dv) {
  const int nc = a.block / BM;
  if (a.Sq < 1 || a.Sk < 1 || nc < 1 || nc > MAX_NC || nc * BM != a.block)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)run<16>(a, dq, dk, dv);
    case 32: return (int)run<32>(a, dq, dk, dv);
    case 64: return (int)run<64>(a, dq, dk, dv);
    case 128: return (int)run<128>(a, dq, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* kbias, int bias_ld, const void* lse,
               const void* delta, int rows_ld, int B, int H, int Sq, int Sk,
               const long long* strides, int block, int causal,
               int causal_offset, float scale, unsigned int drop_thresh,
               float inv_keep, unsigned int seed, int HT, int HO,
               void* stream) {
  return Args{q, k, v, g, static_cast<const float*>(kbias), bias_ld,
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              rows_ld, B, H, Sq, Sk, strides, block, causal, causal_offset,
              scale, drop_thresh, inv_keep, seed, HT, HO,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dynamic shared memory of a dq (dkv = 0) or dkv CTA at head dim D
int flash_bwd_smem_bytes(int D, int dkv) {
  switch (D) {
    case 16: return (int)(dkv ? DkvSmem<16>::BYTES : DqSmem<16>::BYTES);
    case 32: return (int)(dkv ? DkvSmem<32>::BYTES : DqSmem<32>::BYTES);
    case 64: return (int)(dkv ? DkvSmem<64>::BYTES : DqSmem<64>::BYTES);
    case 128: return (int)(dkv ? DkvSmem<128>::BYTES : DqSmem<128>::BYTES);
    default: return -1;
  }
}

// q, k, v, g: bf16 (B, S, H, D), 16-byte aligned, strides (in elements)
// q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh
// that nest and are multiples of 8.  kbias: null or (B, Sk) f32, 16-byte
// aligned, row stride bias_ld a multiple of 4.  lse, delta: (B*H, Sq) f32,
// 16-byte aligned, row stride rows_ld a multiple of 4.  block: 64 or 128
// keys (dkv) or queries (dq) a CTA, the plan's choice.  inv_keep =
// 1 / (1 - p_drop).  HT, HO: the dropout hash takes head h of batch b as
// batch-head b * HT + HO + h (HT = H, HO = 0 outside tensor parallelism).
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* g, const void* kbias, int bias_ld,
                       const void* lse, const void* delta, int rows_ld,
                       void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                       const long long* strides, int block, int causal,
                       int causal_offset, float scale,
                       unsigned int drop_thresh, float inv_keep,
                       unsigned int seed, int HT, int HO, void* stream) {
  const Args a = make_args(q, k, v, g, kbias, bias_ld, lse, delta, rows_ld, B,
                           H, Sq, Sk, strides, block, causal, causal_offset,
                           scale, drop_thresh, inv_keep, seed, HT, HO,
                           stream);
  return dispatch(a, D, nullptr, static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv));
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* g, const void* kbias, int bias_ld,
                      const void* lse, const void* delta, int rows_ld,
                      void* dq, int B, int H, int Sq, int Sk, int D,
                      const long long* strides, int block, int causal,
                      int causal_offset, float scale,
                      unsigned int drop_thresh, float inv_keep,
                      unsigned int seed, int HT, int HO, void* stream) {
  const Args a = make_args(q, k, v, g, kbias, bias_ld, lse, delta, rows_ld, B,
                           H, Sq, Sk, strides, block, causal, causal_offset,
                           scale, drop_thresh, inv_keep, seed, HT, HO,
                           stream);
  return dispatch(a, D, static_cast<bf16*>(dq), nullptr, nullptr);
}

}  // extern "C"
