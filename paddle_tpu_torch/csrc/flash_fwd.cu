// Flash-attention forward for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_flash_fwd_kernel (:120,
// launched by _flash_forward, pl.pallas_call at :221) together with the
// transpose-and-pad shim of flash_attention.  It computes the same
// function:
//
//   s   = (q k^T) * scale + kbias[b, k]          (f32)
//   s   = DEFAULT_MASK_VALUE where causal and q + causal_offset < k
//   online softmax over key tiles: m, l, acc     (f32)
//   p~  = keep(seed, bh, q, k) ? p / (1 - p_drop) : 0   (_keep_mask3 hash)
//   acc = alpha * acc + bf16(p~) v
//   o   = acc / l (bf16),  lse = m + log(l) (f32)
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, H, D) read in place by strides (the
// last dim contiguous, the others multiples of 8 elements), o (B, Sq, H,
// D) contiguous, lse (B, H, Sq).  The ragged Sq/Sk edges are masked here,
// so nothing is padded or transposed around the call.  Keys past Sk are
// left out of the softmax entirely.  D in {16, 32, 64, 128}.
//
// Design: one CTA per (batch*head, 64 or 128 queries), chosen by
// ops/kernels/attention.py::_flash_plan so that few queries still fill
// the card.  A CTA is NC = 1 or 2 warpgroups of 64 query rows each, and
// nothing else:
//   - K and V tiles of 64 keys come into a ring of NST stages by TMA over
//     4-D tensor maps (D, H, S, B) whose strides are the tensors' own
//     (rows past the sequence arrive as zeros), with the tile's 64 key
//     biases by a 2-D map over the (B, Sk) f32 bias; a stage's mbarrier
//     completes when the bytes have landed.  Keys past Sk score -inf on
//     the last tile, so they drop out of the softmax.  Thread 0 loads Q and the
//     first NST tiles; after that the last warp to finish with a stage
//     (a counter in shared memory) refills it.  There is no producer
//     warp: the registers a launch gives a thread are counted over the
//     block's threads rounded up to whole warpgroups, so a producer warp
//     would cost the consumers a third of theirs.  Two CTAs then share
//     an SM at D <= 64 without dropout (128 registers a thread).
//   - a consumer computes S = Q K^T with wgmma m64n64k16, both operands
//     in shared memory (K-major, the swizzle the head dim allows: 32, 64
//     or 128 bytes), and keeps S in its registers: a thread holds 2 rows
//     x 16 columns.  The softmax runs there: scale and key bias in one
//     FMA, the causal mask only on tiles that cross the diagonal, the row
//     max over the four threads of a row by two quad shuffles, p by ex2
//     of (s - m) * log2(e), a per-thread partial of l (summed over the
//     quad once, at the end), the dropout hash per element from the
//     coordinates the layout gives.  The S accumulator's layout is the
//     register A-fragment layout of wgmma, so P becomes bf16 in place and
//     O += P V runs as wgmma m64nDk16 with A from registers and V as an
//     MN-major B from shared memory.  O stays in registers (D/2 a
//     thread); the per-row rescale by alpha is a register multiply.
//   - the epilogue divides by l, stages the bf16 O rows in the
//     warpgroup's own Q rows (no longer read) and stores them as 16-byte
//     rows, and writes lse = m + log(l) per row.
// The consumers run unsynchronised on the same K/V stages, so one's
// softmax overlaps another's wgmma.  Each consumer also overlaps its own:
// it issues the next tile's S before this tile's O += P V and runs the
// next softmax while that product is on the tensor pipe, with the bf16
// P of two tiles in turns in registers.
//
// Bound on the H100: at BERT-base (B=32, S=512, 12 heads of 64) the work
// is 4 B H S^2 D = 25.8 GFLOP against ~50 MB of q/k/v/o: 0.026 ms of
// tensor cores and 0.015 ms of HBM.  In practice the limit is the
// element work on the 100.7 M scores a call: one ex2 each on the SFU
// (16 a clock an SM: ~0.026 ms) and some ten FP32 instructions each, and
// with dropout the ~15 integer instructions of the hash.  The design
// keeps all of it in registers (no score, probability or accumulator
// round trip through shared memory), reduces rows by quad shuffles,
// defers the l reduction to the end, masks causally only on the diagonal
// tiles, and lets the two warpgroups (and co-resident CTAs) overlap
// element work with the tensor pipe.

#include <string.h>

#include "flash_common.cuh"

using namespace flash;

namespace {

// CTAs an SM holds: two (128 registers a thread) where the softmax state
// fits, at D <= 64 without dropout; else one
template <int D, bool DROP>
__host__ __device__ constexpr int min_ctas() {
  return D <= 64 && !DROP ? 2 : 1;
}

// shared memory: the CTA's Q rows, then the K, V and key-bias stages
template <int D>
struct Tile : Geom<D> {
  using G = Geom<D>;
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)G::NATOM * G::RES;
  static constexpr size_t V = K + (size_t)NST * G::TILE;
  static constexpr size_t BIAS = V + (size_t)NST * G::TILE;
  static constexpr size_t BAR = BIAS + (size_t)NST * BK * 4;
  static constexpr size_t BYTES = BAR + (NST + 1) * 8 + NST * 4 + 1024;  // + alignment
};

// The online softmax of one thread's two rows (row0 and row1 = row0 + 8)
// over key tiles: running max m, partial sum l (over this thread's
// columns only; the quad's four partials are summed at the end).
struct Softmax {
  int row0, row1, cq, Sk, causal, causal_offset, first_row;
  float scale;
  uint32_t drop_thresh;
  float inv_keep;
  uint32_t seed, bh;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // scores of the tile at key k0 (s: the S accumulator, sb: its key
  // biases, or null) to bf16 probabilities pa (the A fragments of
  // O += P V), with dropout; returns the factors (row0, row1) that
  // rescale O
  template <bool DROP>
  __device__ __forceinline__ float2 tile(float* s, const float* sb, int k0,
                                         uint32_t (*pa)[4]) {
    const bool diag = causal && k0 + BK - 1 > first_row + causal_offset;
    const bool edge = k0 + BK > Sk;  // the tile holds keys past Sk
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        const float bv = sb != nullptr ? sb[col] : 0.f;
        float v0 = fmaf(s[4 * j + e], scale, bv);
        float v1 = fmaf(s[4 * j + 2 + e], scale, bv);
        if (diag && k0 + col < Sk) {
          if (row0 + causal_offset < k0 + col) v0 = MASK_VALUE;
          if (row1 + causal_offset < k0 + col) v1 = MASK_VALUE;
        }
        if (edge && k0 + col >= Sk) v0 = v1 = -INFINITY;  // left out
        s[4 * j + e] = v0;
        s[4 * j + 2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    // the tile has a key < Sk, so the new max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float2 alpha = make_float2(ex2((m0 - mn0) * LOG2E),
                                     ex2((m1 - mn1) * LOG2E));
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = ex2((s[4 * j + e] - mn0) * LOG2E);
        float p1 = ex2((s[4 * j + 2 + e] - mn1) * LOG2E);
        ls0 += p0;
        ls1 += p1;
        if constexpr (DROP) {
          const uint32_t kc = (uint32_t)(k0 + 8 * j + cq + e);
          p0 = keep_hash(seed, bh, (uint32_t)row0, kc) >= drop_thresh
                   ? p0 * inv_keep : 0.f;
          p1 = keep_hash(seed, bh, (uint32_t)row1, kc) >= drop_thresh
                   ? p1 * inv_keep : 0.f;
        }
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
      }
    }
    l0 = l0 * alpha.x + ls0;
    l1 = l1 * alpha.y + ls1;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) acc_to_a(pa[j], s, j);
    return alpha;
  }
};

template <int D, bool DROP>
__global__ void __launch_bounds__(MAX_NC * 128, min_ctas<D, DROP>())
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_bias, int has_bias,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                 int Sk, int causal, int causal_offset, float scale,
                 uint32_t drop_thresh, float keep_prob, uint32_t seed, int HT,
                 int HO) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sbias = reinterpret_cast<float*>(smem + T::BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR);
  uint64_t* qbar = full + NST;
  int* released = reinterpret_cast<int*>(qbar + 1);  // warps done, by stage

  const int nc = blockDim.x / 128;  // consumer warpgroups
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * nc * BM;
  int n_kt = (Sk + BK - 1) / BK;
  // every row of the CTA keeps key 0 (q0 + offset >= 0), so key tiles
  // wholly above the diagonal add exp(MASK - m) == 0 and are skipped
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
    mbar_init(qbar, 1);
    fence_barrier_init();
    mbar_expect_tx(qbar, nc * BM * D * 2);
    for (int a = 0; a < T::NATOM; ++a)
      tma_load_4d(smem + T::Q + a * T::RES, &tm_q, qbar, a * T::ATOM, h, q0, b);
    for (int i = 0; i < NST && i < n_kt; ++i) fill(i, i);
  }
  __syncthreads();

  // Per key tile t the consumer issues S(t+1) = Q K(t+1)^T, then
  // O += P(t) V(t), and runs the softmax of tile t+1 while O += P(t) V(t)
  // is still on the tensor pipe; O is rescaled once that product is done.
  const int c = warpgroup_index();
  const int tw = threadIdx.x - 128 * c;
  const int lane = tw % 32;
  const int r0 = (tw / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of 64
  const int cq = (lane % 4) * 2;             // column in each 8-column group
  const int row0 = q0 + c * BM + r0;         // absolute query rows
  unsigned char* sq = smem + T::Q + c * BM * T::ROWB;
  Softmax sm{row0, row0 + 8, cq, Sk, causal, causal_offset, q0 + c * BM,
             scale, drop_thresh, 1.f / keep_prob, seed,
             (uint32_t)(b * HT + HO + h)};  // the hash's global batch-head

  float oacc[D / 2];  // O: rows r0, r0 + 8 as an f32 accumulator
  float s[BK / 2];    // S of one key tile, then its probabilities
  // bf16 P of two tiles, in turns: one is read by O += P V while the
  // softmax writes the other (a copy between them would make ptxas
  // serialize the wgmma that reads it)
  uint32_t pa[BK / 16][4], pb[BK / 16][4];
  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  mma_rows_tile_t<D>(s, sq, smem + T::K);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<BK / 2>(s);
  const float* sb = has_bias ? sbias : nullptr;
  sm.tile<DROP>(s, sb, 0, pa);
  int stage = 0, kt = 0;
  uint32_t phase = 0;
  // tile kt's O += P V (P in cur) beside tile kt+1's S and softmax
  // (into nxt)
  auto step = [&](uint32_t (*cur)[4], uint32_t (*nxt)[4]) {
    const int ns = stage + 1 == NST ? 0 : stage + 1;
    const uint32_t nphase = stage + 1 == NST ? phase ^ 1 : phase;
    mbar_wait(&full[ns], nphase);
    wgmma_fence();
    mma_rows_tile_t<D>(s, sq, smem + T::K + ns * T::TILE);
    wgmma_commit();
    mma_regs_tile<D>(oacc, cur, smem + T::V + stage * T::TILE, kt > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S of the next tile; O += P V may still run
    fence_regs<BK / 2>(s);
    const float2 alpha =
        sm.tile<DROP>(s, sb != nullptr ? sb + ns * BK : nullptr, (kt + 1) * BK, nxt);
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
    // the stage of tile kt is done: the last warp refills it with tile
    // kt + NST
    release_stage(&released[stage], nc * 4, lane, [&]() {
      if (kt + NST < n_kt) fill(stage, kt + NST);
    });
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= (i / 2) % 2 ? alpha.y : alpha.x;
    stage = ns;
    phase = nphase;
    ++kt;
  };
  // the last tile's O += P V alone
  auto last = [&](uint32_t (*cur)[4]) {
    wgmma_fence();
    mma_regs_tile<D>(oacc, cur, smem + T::V + stage * T::TILE, kt > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
  };
  for (;;) {
    if (kt + 1 == n_kt) { last(pa); break; }
    step(pa, pb);
    if (kt + 1 == n_kt) { last(pb); break; }
    step(pb, pa);
  }

  // epilogue: o = O / l through the warpgroup's Q rows, lse = m + log l
  const int row1 = row0 + 8;
  const float l0 = quad_sum(sm.l0), l1 = quad_sum(sm.l1);
  const float il0 = 1.f / l0, il1 = 1.f / l1;
  stage_acc<D>(sq, oacc, r0, cq, il0, il1);
  if (lane % 4 == 0) {
    if (row0 < Sq) lse[(long long)bh * Sq + row0] = sm.m0 + logf(l0);
    if (row1 < Sq) lse[(long long)bh * Sq + row1] = sm.m1 + logf(l1);
  }
  named_barrier(1 + c, 128);
  store_rows<D>(sq, o, b, h, H, Sq, q0 + c * BM, tw);
}

template <int D, bool DROP>
cudaError_t launch(const CUtensorMap* maps, int has_bias, void* o, float* lse,
                   int B, int H, int Sq, int Sk, int nc, int causal,
                   int causal_offset,
                   float scale, uint32_t drop_thresh, float keep_prob,
                   uint32_t seed, int HT, int HO, cudaStream_t stream) {
  const size_t bytes = Tile<D>::BYTES;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Sq + nc * BM - 1) / (nc * BM), B * H);
  flash_fwd_kernel<D, DROP><<<grid, nc * 128, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], has_bias, static_cast<bf16*>(o), lse,
      H, Sq, Sk, causal, causal_offset, scale, drop_thresh, keep_prob, seed,
      HT, HO);
  return cudaGetLastError();
}

// kbias: (B, Sk) f32 with row stride bias_ld (a multiple of 4), or null
template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const float* kbias,
                int bias_ld, void* o, float* lse, int B, int H, int Sq, int Sk,
                const long long* st, int block_q, int causal,
                int causal_offset, float scale, uint32_t drop_thresh,
                float keep_prob, uint32_t seed, int HT, int HO,
                cudaStream_t stream) {
  const int nc = block_q / BM;
  if (nc < 1 || nc > MAX_NC || nc * BM != block_q) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  memset(&maps[3], 0, sizeof(CUtensorMap));  // unread without a bias
  if (!map_bshd<D>(&maps[0], q, B, Sq, H, st, block_q) ||
      !map_bshd<D>(&maps[1], k, B, Sk, H, st + 3, BK) ||
      !map_bshd<D>(&maps[2], v, B, Sk, H, st + 6, BK) ||
      (kbias != nullptr &&
       !map_2d(&maps[3], kbias, B, Sk, bias_ld, 1, BK, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_DATA_TYPE_FLOAT32)))
    return cudaErrorInvalidValue;
  const int has_bias = kbias != nullptr;
  return drop_thresh != 0u
             ? launch<D, true>(maps, has_bias, o, lse, B, H, Sq, Sk, nc, causal,
                               causal_offset, scale, drop_thresh, keep_prob,
                               seed, HT, HO, stream)
             : launch<D, false>(maps, has_bias, o, lse, B, H, Sq, Sk, nc,
                                causal, causal_offset, scale, drop_thresh,
                                keep_prob, seed, HT, HO, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// strides (in elements): q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
// v_sh; kbias: null or (B, Sk) f32, 16-byte aligned, with row stride
// bias_ld a multiple of 4; block_q: 64 or 128 queries a CTA (the plan's
// choice); HT, HO: the dropout hash takes head h of batch b as batch-head
// b * HT + HO + h (HT = H, HO = 0 outside tensor parallelism)
int flash_fwd_bf16(const void* q, const void* k, const void* v,
                   const void* kbias, int bias_ld, void* o, void* lse, int B,
                   int H,
                   int Sq, int Sk, int D, const long long* strides,
                   int block_q, int causal, int causal_offset, float scale,
                   unsigned int drop_thresh, float keep_prob,
                   unsigned int seed, int HT, int HO, void* stream) {
  const float* kb = static_cast<const float*>(kbias);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return run<16>(q, k, v, kb, bias_ld, o, ls, B, H, Sq, Sk, strides,
                     block_q, causal, causal_offset, scale, drop_thresh, keep_prob,
                     seed, HT, HO, s);
    case 32:
      return run<32>(q, k, v, kb, bias_ld, o, ls, B, H, Sq, Sk, strides,
                     block_q, causal, causal_offset, scale, drop_thresh, keep_prob,
                     seed, HT, HO, s);
    case 64:
      return run<64>(q, k, v, kb, bias_ld, o, ls, B, H, Sq, Sk, strides,
                     block_q, causal, causal_offset, scale, drop_thresh, keep_prob,
                     seed, HT, HO, s);
    case 128:
      return run<128>(q, k, v, kb, bias_ld, o, ls, B, H, Sq, Sk, strides,
                      block_q, causal, causal_offset, scale, drop_thresh, keep_prob,
                      seed, HT, HO, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
