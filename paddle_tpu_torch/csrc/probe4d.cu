// The layout-probe kernel for Hopper (sm_90a): bf16 in, f32 math.
//
// Replaces the three Pallas kernels of tools/kernel4d_probe.py, which price
// the layout question behind the flash kernels (read the projection output
// in place, or pay the merge transposes to (B*H, S, D) on every call):
//
//   probe_4d_bf16      <- build        (:29)   q/k/v/o (B, S, H, D)
//   probe_fold3d_bf16  <- build_fold3d (:78)   q/k/v/o (B, S, H*D), head h
//                                              at lanes h*D .. h*D + D - 1
//   probe_merged_bf16  <- main's kernel3 (:226) q/k/v/o (B*H, S, D)
//
// Each computes, per (batch, head), one-shot softmax attention with no
// mask, exactly as kernel4d_probe.py:43-56 does:
//
//   s = (q k^T) * scale            f32, scale = 1/sqrt(D)
//   m = rowmax(s), p = exp(s - m), l = rowsum(p)        f32
//   P = bf16(p / l)                normalised BEFORE the cast
//   o = bf16(P v)                  f32 accumulation, one cast
//
// One kernel body (probe_kernel<D>) serves the three layouts; they differ
// only in the tensor maps the host encodes over the operands' own strides
// (nothing is copied or transposed): 4d as (D, H, S, B), fold3d as the
// same bytes seen as (B, S, H, D), merged as (D, 1, S, B*H).  On the same
// values the three therefore give the same bits, and so does a second
// launch: no atomics touch a value (the only atomic is the shared-memory
// count of warps done with a ring stage, which orders refills).
//
// Design: one CTA per (batch*head, 64 or 128 queries), chosen by
// ops/kernels/probe.py::_probe_plan; a CTA is one or two warpgroups of 64
// query rows, and nothing else (no producer warp).  Q stays resident; K
// and V tiles of 64 keys stream through a ring of PST stages by TMA
// (rows past S arrive as zeros), each stage's mbarrier completing when
// its bytes have landed, and the last warp done with a stage refills it.
// P must be normalised before its cast, so the whole row's m and l are
// needed before any of P exists: two passes over the keys.
//   - Pass 1 streams K alone.  S = Q K^T by wgmma m64n64k16 (both
//     operands K-major in shared memory) into registers; the next tile's
//     S is issued before this tile's row statistics run, into a second
//     accumulator.  A thread keeps, for its two rows, the running max m
//     (in log2 units) and a rescaled partial sum l, as flash_fwd does.
//   - Pass 2 streams K and V (K's second read comes from L2: K and V of
//     all heads at the tool's shape are 12.6 MB against 50 MB).  S again;
//     then P = bf16(ex2(s * scale * log2(e) - (m + log2 l))), one FMA and
//     one ex2 a score, in the accumulator's registers, which are the
//     register A fragments of O += P V (wgmma m64nDk16, V an MN-major B
//     from shared memory).  As in flash_fwd, the next tile's S is issued
//     with this tile's P V, and its P is formed while P V runs.
//   - Keys past S score -inf in both passes and drop out; query rows
//     past S are computed on zero rows and not written.  The epilogue
//     stages bf16 O in the warpgroup's own Q rows and stores 16-byte
//     rows into the contiguous output of each layout.
//
// Bound on the H100: at the tool's shape (8, 512, 12, 64) each call reads
// q/k/v and writes o once, 25.2 MB (7.5 us at 3.35 TB/s), against 6.4
// GFLOP of the function (6.5 us at 989 TFLOP/s): bytes, just.  The design
// does 9.7 GFLOP (pass 2 forms S again) and two ex2 a score (50 M on the
// SFU, ~14 us at 16 a clock an SM), so the element work and the second
// product, not the bytes, set its pace.  It keeps all of it in registers
// (no score block in shared memory, rows reduced by quad shuffles) and
// lets the two warpgroups of a CTA, and the two CTAs an SM holds at
// D <= 64, overlap it with the tensor pipe.  On the card (PERF.md) a
// variant without pass 1's ex2 was barely faster: each warpgroup's chain
// of dependent steps (wait, product, statistics), more than the SFU,
// sets the pace.

#include "flash_common.cuh"

using namespace flash;

namespace {

constexpr int PST = 4;  // ring stages (each a K and a V tile)

// CTAs an SM holds: two (128 registers a thread) at D <= 64; else one
template <int D>
__host__ __device__ constexpr int min_ctas() {
  return D <= 64 ? 2 : 1;
}

// shared memory: the CTA's Q rows, then the K and V stages.  BYTES is
// what ops/kernels/probe.py::_probe_smem computes (1280 D + 1080).
template <int D>
struct Tile : Geom<D> {
  using G = Geom<D>;
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)G::NATOM * G::RES;
  static constexpr size_t V = K + (size_t)PST * G::TILE;
  static constexpr size_t BAR = V + (size_t)PST * G::TILE;
  static constexpr size_t BYTES = BAR + (PST + 1) * 8 + PST * 4 + 1024;  // + alignment
};

// keys past S in the tile at k0 score -inf (their p is then 0)
__device__ __forceinline__ void mask_keys(float* s, int k0, int cq, int S) {
  if (k0 + BK <= S) return;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (k0 + 8 * j + cq + e >= S) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
    }
  }
}

// Pass 1's statistics of one thread's two rows (r0 and r0 + 8): the
// running max m of s * sl2 (log2 units) and the partial sum l of
// ex2(s * sl2 - m) over this thread's columns (the quad's four partials
// are summed once, after the last tile).
struct RowStats {
  float sl2;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  __device__ __forceinline__ void tile(float* s, int k0, int cq, int S) {
    mask_keys(s, k0, cq, S);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // the tile holds key k0 < S, so the new max is finite (sl2 > 0)
    const float mn0 = fmaxf(m0, quad_max(mx0) * sl2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * sl2);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ls0 += ex2(fmaf(s[4 * j + e], sl2, -mn0));
        ls1 += ex2(fmaf(s[4 * j + 2 + e], sl2, -mn1));
      }
    }
    l0 = l0 * ex2(m0 - mn0) + ls0;
    l1 = l1 * ex2(m1 - mn1) + ls1;
    m0 = mn0;
    m1 = mn1;
  }
};

// Pass 2: the tile's scores s to P = bf16(ex2(s * sl2 - c)), c = m +
// log2(l) of the row, as the A fragments pa of O += P V
__device__ __forceinline__ void probs(float* s, int k0, int cq, int S,
                                      float sl2, float c0, float c1,
                                      uint32_t (*pa)[4]) {
  mask_keys(s, k0, cq, S);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -c0));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sl2, -c1));
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) acc_to_a(pa[j], s, j);
}

// q/k/v by their tensor maps (D, H, S, B); o a contiguous (B, S, H, D)
// bf16 output.  blockIdx.y = b*H + h.
template <int D>
__global__ void __launch_bounds__(MAX_NC * 128, min_ctas<D>())
probe_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
             int H, int S, float scale) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR);
  uint64_t* qbar = full + PST;
  int* released = reinterpret_cast<int*>(qbar + 1);  // warps done, by stage

  const int nc = blockDim.x / 128;  // warpgroups
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * nc * BM;
  const int n_kt = (S + BK - 1) / BK;
  const int n_ld = 2 * n_kt;  // loads: pass 1's K tiles, then pass 2's K and V

  // load i into stage st, announced on full[st]
  auto fill = [&](int st, int i) {
    const bool kv = i >= n_kt;
    const int kt = kv ? i - n_kt : i;
    mbar_expect_tx(&full[st], (kv ? 2 : 1) * T::TILE);
    for (int a = 0; a < T::NATOM; ++a) {
      tma_load_4d(smem + T::K + st * T::TILE + a * BK * T::ROWB, &tm_k,
                  &full[st], a * T::ATOM, h, kt * BK, b);
      if (kv)
        tma_load_4d(smem + T::V + st * T::TILE + a * BK * T::ROWB, &tm_v,
                    &full[st], a * T::ATOM, h, kt * BK, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < PST; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
    mbar_expect_tx(qbar, nc * BM * D * 2);
    for (int a = 0; a < T::NATOM; ++a)
      tma_load_4d(smem + T::Q + a * T::RES, &tm_q, qbar, a * T::ATOM, h, q0, b);
    for (int i = 0; i < PST && i < n_ld; ++i) fill(i, i);
  }
  __syncthreads();

  const int c = warpgroup_index();
  const int tw = threadIdx.x - 128 * c;
  const int lane = tw % 32;
  const int r0 = (tw / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of 64
  const int cq = (lane % 4) * 2;             // column in each 8-column group
  unsigned char* sq = smem + T::Q + c * BM * T::ROWB;
  const float sl2 = scale * LOG2E;

  // the ring: the load being read is in `stage`, of parity `phase`; the
  // last warp done with it refills the stage with load ld + PST
  int stage = 0, ld = 0;
  uint32_t phase = 0;
  auto consumed = [&]() {
    release_stage(&released[stage], nc * 4, lane, [&]() {
      if (ld + PST < n_ld) fill(stage, ld + PST);
    });
    ++ld;
    if (++stage == PST) {
      stage = 0;
      phase ^= 1;
    }
  };

  // ---- pass 1: m and l over K tiles ------------------------------------------
  RowStats rs{sl2};
  float s[BK / 2], s2[BK / 2];  // S of two tiles, in turns
  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  mma_rows_tile_t<D>(s, sq, smem + T::K);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<BK / 2>(s);
  int kt = 0;
  // tile kt's statistics (S in cur) beside tile kt+1's S (into nxt)
  auto step1 = [&](float* cur, float* nxt) {
    const int ns = stage + 1 == PST ? 0 : stage + 1;
    mbar_wait(&full[ns], stage + 1 == PST ? phase ^ 1 : phase);
    wgmma_fence();
    mma_rows_tile_t<D>(nxt, sq, smem + T::K + ns * T::TILE);
    wgmma_commit();
    consumed();  // tile kt's K was read by its finished S
    rs.tile(cur, kt * BK, cq, S);
    wgmma_wait<0>();
    fence_regs<BK / 2>(nxt);
    ++kt;
  };
  auto last1 = [&](float* cur) {
    consumed();
    rs.tile(cur, kt * BK, cq, S);
  };
  for (;;) {
    if (kt + 1 == n_kt) { last1(s); break; }
    step1(s, s2);
    if (kt + 1 == n_kt) { last1(s2); break; }
    step1(s2, s);
  }
  const float c0 = rs.m0 + log2f(quad_sum(rs.l0));
  const float c1 = rs.m1 + log2f(quad_sum(rs.l1));

  // ---- pass 2: O = P V over K and V tiles --------------------------------------
  float oacc[D / 2];  // O: rows r0, r0 + 8 as an f32 accumulator
  // bf16 P of two tiles, in turns: one is read by O += P V while the
  // other is formed (a copy between them would make ptxas serialize the
  // wgmma that reads it)
  uint32_t pa[BK / 16][4], pb[BK / 16][4];
  mbar_wait(&full[stage], phase);
  wgmma_fence();
  mma_rows_tile_t<D>(s, sq, smem + T::K + stage * T::TILE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<BK / 2>(s);
  probs(s, 0, cq, S, sl2, c0, c1, pa);
  kt = 0;
  // tile kt's O += P V (P in cur) beside tile kt+1's S and P (into nxt)
  auto step2 = [&](uint32_t (*cur)[4], uint32_t (*nxt)[4]) {
    const int ns = stage + 1 == PST ? 0 : stage + 1;
    mbar_wait(&full[ns], stage + 1 == PST ? phase ^ 1 : phase);
    wgmma_fence();
    mma_rows_tile_t<D>(s, sq, smem + T::K + ns * T::TILE);
    wgmma_commit();
    mma_regs_tile<D>(oacc, cur, smem + T::V + stage * T::TILE, kt > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S of the next tile; O += P V may still run
    fence_regs<BK / 2>(s);
    probs(s, (kt + 1) * BK, cq, S, sl2, c0, c1, nxt);
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
    consumed();
    ++kt;
  };
  // the last tile's O += P V alone
  auto last2 = [&](uint32_t (*cur)[4]) {
    wgmma_fence();
    mma_regs_tile<D>(oacc, cur, smem + T::V + stage * T::TILE, kt > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
  };
  for (;;) {
    if (kt + 1 == n_kt) { last2(pa); break; }
    step2(pa, pb);
    if (kt + 1 == n_kt) { last2(pb); break; }
    step2(pb, pa);
  }

  // epilogue: bf16 O through the warpgroup's Q rows, 16-byte row stores
  stage_acc<D>(sq, oacc, r0, cq, 1.f, 1.f);
  named_barrier(1 + c, 128);
  store_rows<D>(sq, o, b, h, H, S, q0 + c * BM, tw);
}

// st: 9 element strides (batch, seq, head) of q, k and v in turn, each
// tensor read as (B, S, H, D); o contiguous (B, S, H, D); block_q and
// smem_bytes: the plan's
template <int D>
cudaError_t run(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, const long long* st, int block_q,
                long long smem_bytes, float scale, cudaStream_t stream) {
  const size_t bytes = Tile<D>::BYTES;
  const int nc = block_q / BM;
  if (nc < 1 || nc > MAX_NC || nc * BM != block_q ||
      smem_bytes != (long long)bytes)
    return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!map_bshd<D>(&maps[0], q, B, S, H, st, block_q) ||
      !map_bshd<D>(&maps[1], k, B, S, H, st + 3, BK) ||
      !map_bshd<D>(&maps[2], v, B, S, H, st + 6, BK))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + block_q - 1) / block_q, B * H);
  probe_kernel<D><<<grid, nc * 128, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), H, S, scale);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int D, const long long* st, int block_q,
             long long smem_bytes, float scale, void* stream) {
  if (S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return run<16>(q, k, v, o, B, S, H, st, block_q, smem_bytes, scale, s);
    case 32: return run<32>(q, k, v, o, B, S, H, st, block_q, smem_bytes, scale, s);
    case 64: return run<64>(q, k, v, o, B, S, H, st, block_q, smem_bytes, scale, s);
    case 128: return run<128>(q, k, v, o, B, S, H, st, block_q, smem_bytes, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (B, S, H, D) by strides; strides (elements): q_sb, q_ss, q_sh, k_sb,
// k_ss, k_sh, v_sb, v_ss, v_sh
int probe_4d_bf16(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int D, const long long* strides,
                  int block_q, long long smem_bytes, float scale,
                  void* stream) {
  return dispatch(q, k, v, o, B, S, H, D, strides, block_q, smem_bytes, scale,
                  stream);
}

// (B, S, H*D) read as (B, S, H, D) with heads D apart; strides
// (elements): q_sb, q_ss, k_sb, k_ss, v_sb, v_ss
int probe_fold3d_bf16(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int D, const long long* strides,
                      int block_q, long long smem_bytes, float scale,
                      void* stream) {
  const long long st[9] = {strides[0], strides[1], D, strides[2], strides[3],
                           D, strides[4], strides[5], D};
  return dispatch(q, k, v, o, B, S, H, D, st, block_q, smem_bytes, scale,
                  stream);
}

// (B*H, S, D) planes read as (B*H, S, 1, D) (the one head's stride is the
// row's); strides (elements): q_sp, q_ss, k_sp, k_ss, v_sp, v_ss
int probe_merged_bf16(const void* q, const void* k, const void* v, void* o,
                      int planes, int S, int D, const long long* strides,
                      int block_q, long long smem_bytes, float scale,
                      void* stream) {
  const long long st[9] = {strides[0], strides[1], strides[1],
                           strides[2], strides[3], strides[3],
                           strides[4], strides[5], strides[5]};
  return dispatch(q, k, v, o, planes, S, 1, D, st, block_q, smem_bytes, scale,
                  stream);
}

}  // extern "C"
