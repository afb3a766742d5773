// Ragged paged attention for Hopper (sm_90a): bf16 in, f32 accumulate.
//
// Replaces paddle_tpu/ops/pallas/attention.py::_ragged_paged_kernel (:895,
// launched by _ragged_paged_forward, pl.pallas_call at :991), the
// attention of the serving decode path.  It computes the same function:
//
//   pages of sequence b: i = 0 .. W-1, taking part only if
//                        i == 0 or i * S < lengths[b]   (page 0 always, so
//                        a length-0 lane yields the uniform softmax over it)
//   s   = (q k^T) * scale                               (f32)
//   s   = DEFAULT_MASK_VALUE where kpos > qpos[b, t]
//   keys of pages that take no part: -inf
//   online softmax over the pages' keys: m, l, acc      (f32)
//   acc = alpha * acc + bf16(p) v
//   o   = acc / l                                       (bf16)
//
// Layout: page_rows (B, W) int32, lengths (B,) int32, q (B, T, H, D),
// k/v pools (P, S, H, D) (one layer's plane of a multi-layer pool),
// qpos (B, T) int32, o (B, T, H, D); all contiguous.  The page ids are
// read here, inside the kernels, straight from page_rows: nothing gathers
// the (B, W*S) keys of a sequence into a dense tensor.  Page ids are
// clamped to [0, P) so a stale row can never read outside the pool.  The
// included pages are the prefix 0 .. n_pages-1 of the row (i*S < len for
// i < ceil(len/S), and page 0 always).
//
// What bounds it on the H100: a decode step (T = 1) does 4 D flops per
// key and head against 4 D bytes of K and V: far below the bf16 ridge,
// so it is bound by the bytes of the included pages, and by how many of
// them are in flight at once.  A chunk step (T = 256) does T times the
// flops on the same bytes, near the ridge: there the tensor cores have
// to do the products.  Two paths, chosen on the host by shape alone
// (ops/kernels/attention.py::_ragged_plan, which never reads lengths or
// qpos: those live on the card):
//
// Split path (few query rows: the decode step).  One CTA per (query row,
// run of `pps` consecutive row pages, head group, sequence), so the
// pages of the longest lane spread over many SMs instead of one CTA
// walking them all; CTAs whose run starts past the lane's included pages
// exit at once.  A page of all heads is one contiguous S*H*D*2-byte block
// of the pool (24 KB at BERT-base): the pages' K and V for the CTA's
// heads arrive KS keys a stage (16, a whole page of 16; 8 where the page
// size is not a multiple of 16) by 1-D bulk copies into a ring of two
// stages on mbarriers (one copy per operand when the group holds every
// head, else one per key row).  Warps
// own heads.  A warp scores four keys at once, eight lanes a key and D/8
// columns a lane (16-byte shared loads, conflict-free), reduces each dot
// over its eight lanes, runs the online softmax per stage, and adds
// bf16(p) V into f32 accumulators in registers; scores and P V run in f32
// on the CUDA cores (the case is far below the ridge: tensor cores would
// idle on 63 of every 64 rows).  KS is a compile-time count, so a
// stage's four key groups are unrolled and their shared loads and
// shuffles overlap.  Heads are split into groups only when two stages of
// all heads do not fit the 227 KB.  A lane whose pages fit one run
// writes o directly; otherwise each CTA writes its (m, l, acc) in f32 to
// a workspace and ragged_merge_kernel combines the runs in split order,
// so two launches give the same bits.  The merge grid is launched as a
// programmatic dependent of the split grid, so its launch overlaps the
// split grid's tail.
//
// Tiled path (many query rows: a prefill chunk; page sizes that divide
// 64).  flash_fwd.cu's design over pages: one CTA per (64 query rows,
// head, sequence) of two warpgroups, which take alternate 64-key tiles
// (halving the chain of tiles a CTA walks) and merge their softmax
// states through shared memory at the end.  The Q tile comes by TMA over
// q's 4-D map (rows past T arrive as zeros and are never written).  Each
// 64-key K or V tile is 64/S page boxes of a 4-D map over the pool (P,
// S, H, D), landing on one stage barrier in the same swizzled row layout
// (S is a multiple of 8, so every box starts on a swizzle period), in a
// ring of four stages (two a warpgroup) refilled by the last warp done
// with one.  S = Q K^T by wgmma, the softmax in registers with each
// row's qpos, P as register A for O += P V (acc_to_a).  Key tiles past
// the tile's largest qpos (when every row sees key 0) or past the
// included pages are skipped by loop bound; keys of a partly included
// last tile score -inf.

#include <limits.h>

#include "flash_common.cuh"

using namespace flash;

namespace {

constexpr int SMEM_OPTIN = 232448;  // bytes a block may use on an H100

// pages 0 .. n-1 of a lane of `len` keys take part
__device__ __forceinline__ int included_pages(int len, int S, int W) {
  const int n = len > 0 ? (len + S - 1) / S : 1;
  return max(1, min(n, W));
}

// ---- split path -----------------------------------------------------------------

namespace split {

constexpr int GROUP = 8;                   // lanes that share a key
constexpr int KEYS = 32 / GROUP;           // keys a warp scores at once
constexpr int MAX_HEADS = 16;              // warps (heads) a CTA at most
constexpr int STAGES = 2;

// columns of lane gl (0..7) of its key group: 8-column runs 64 apart
// (D >= 64), or D/8 consecutive columns (D < 64), so the eight lanes of
// a key read a row's bytes once, in 16-byte (or smaller) pieces
template <int D>
__device__ __forceinline__ int col(int gl, int i) {
  constexpr int N = D / GROUP;
  return N >= 8 ? 64 * (i / 8) + 8 * gl + i % 8 : N * gl + i;
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// the lane's D/8 columns of one bf16 row as f32
template <int D>
__device__ __forceinline__ void load_cols(float* f, const bf16* row, int gl) {
  constexpr int N = D / GROUP;
  if constexpr (N >= 8) {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + col<D>(gl, 8 * c));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = bf2(w[i]);
        f[8 * c + 2 * i] = x.x;
        f[8 * c + 2 * i + 1] = x.y;
      }
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + col<D>(gl, 0));
    const float2 a = bf2(u.x), b = bf2(u.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
    const float2 a = bf2(*reinterpret_cast<const uint32_t*>(row + col<D>(gl, 0)));
    f[0] = a.x; f[1] = a.y;
  }
}

// f[i] as bf16 into the lane's columns of a global row
template <int D>
__device__ __forceinline__ void store_cols(bf16* row, const float* f, int gl) {
  constexpr int N = D / GROUP;
#pragma unroll
  for (int i = 0; i < N; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(row + col<D>(gl, i)) =
        __floats2bfloat162_rn(f[i], f[i + 1]);
}

// grid (n_splits * T, head groups, B), 32 * hg threads: CTA (split sp,
// query row t) takes pages sp*pps .. of sequence b for heads h0 ..
// h0+hn-1, KS keys a stage
template <int D, int KS>
__global__ void __launch_bounds__(MAX_HEADS * 32)
ragged_split_kernel(const int* __restrict__ page_rows,
                    const int* __restrict__ lengths,
                    const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp, const int* __restrict__ qpos,
                    bf16* __restrict__ o, float* __restrict__ ws, int T, int H,
                    int P, int S, int W, float scale, int pps, int n_splits,
                    int hg) {
  constexpr int N = D / GROUP;        // columns a lane
  constexpr int NPASS = KS / KEYS;    // key groups a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = blockIdx.x % n_splits, t = blockIdx.x / n_splits;
  const int h0 = blockIdx.y * hg, b = blockIdx.z;
  const int hn = min(hg, H - h0);
  // the merge grid may launch now and wait for this one (PDL)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // stage st: K at st * 2 * half, V half bytes after it
  const size_t half = (size_t)KS * hg * D * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * 2 * half);
  int* spage = reinterpret_cast<int*>(full + STAGES);
  const int p0 = sp * pps;
  // the lane's length and the run's page ids, loads issued together
  const int* row = page_rows + (long long)b * W + p0;
  const int len = lengths[b];
  const int pid = threadIdx.x < pps && p0 + threadIdx.x < W ? row[threadIdx.x] : 0;
  const int n_pages = included_pages(len, S, W);
  const int n_act = (n_pages + pps - 1) / pps;  // runs that hold pages
  if (sp >= n_act) return;
  const int np = min(pps, n_pages - p0);
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    spage[i] = min(max(i == threadIdx.x ? pid : row[i], 0), P - 1);
  const int cpp = S / KS;  // stages a page
  const int n_chunks = np * cpp;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the K and V rows of chunk c (keys key0 .. key0+KS-1 of one page) for
  // the group's heads into stage st, announced on full[st]
  auto fill = [&](int st, int c) {
    unsigned char* dk = smem + st * 2 * half;
    unsigned char* dv = dk + half;
    const long long row0 = (long long)spage[c / cpp] * S + (c % cpp) * KS;
    const uint32_t bytes = (uint32_t)(KS * hn * D * 2);
    mbar_expect_tx(&full[st], 2 * bytes);
    if (hn == H) {  // the chunk's rows of all heads are contiguous
      bulk_load(dk, kp + row0 * H * D, bytes, &full[st]);
      bulk_load(dv, vp + row0 * H * D, bytes, &full[st]);
    } else {
      const uint32_t rb = (uint32_t)(hn * D * 2);
      for (int r = 0; r < KS; ++r) {
        const long long off = ((row0 + r) * H + h0) * D;
        bulk_load(dk + r * rb, kp + off, rb, &full[st]);
        bulk_load(dv + r * rb, vp + off, rb, &full[st]);
      }
    }
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < STAGES && c < n_chunks; ++c) fill(c, c);

  const int hh = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / GROUP, gl = lane % GROUP;
  const bool active = hh < hn;  // warps past a short last group idle
  const int h = h0 + hh;
  const int qp = qpos[(long long)b * T + t];
  float qf[N], acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  if (active) load_cols<D>(qf, q + (((long long)b * T + t) * H + h) * D, gl);
  float m = -INFINITY, l = 0.f;  // l: this lane's key group's part

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % STAGES;
    mbar_wait(&full[st], (c / STAGES) & 1);
    if (active) {
      const bf16* sk = reinterpret_cast<const bf16*>(smem + st * 2 * half);
      const bf16* sv = reinterpret_cast<const bf16*>(smem + st * 2 * half + half);
      const int kbase = (p0 + c / cpp) * S + (c % cpp) * KS;  // kpos of key 0
      float s[NPASS];
      float cmax = -INFINITY;
#pragma unroll
      for (int p = 0; p < NPASS; ++p) {
        const int key = p * KEYS + grp;
        float kf[N];
        load_cols<D>(kf, sk + (key * hn + hh) * D, gl);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) dot = fmaf(qf[i], kf[i], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        s[p] = kbase + key > qp ? MASK_VALUE : dot * scale;
        cmax = fmaxf(cmax, s[p]);
      }
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 8));
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 16));
      const float mn = fmaxf(m, cmax);  // finite: every key is included
      const float alpha = ex2((m - mn) * LOG2E);
      m = mn;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] *= alpha;
#pragma unroll
      for (int p = 0; p < NPASS; ++p) {
        const float pr = ex2((s[p] - mn) * LOG2E);
        l += pr;
        const float pb = __bfloat162float(__float2bfloat16(pr));
        float vf[N];
        load_cols<D>(vf, sv + ((p * KEYS + grp) * hn + hh) * D, gl);
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = fmaf(pb, vf[i], acc[i]);
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (threadIdx.x == 0 && c + STAGES < n_chunks) fill(st, c + STAGES);
  }
  if (!active) return;

  // the four key groups' partial sums
  l += __shfl_xor_sync(0xffffffffu, l, 8);
  l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  }
  if (grp != 0) return;
  if (n_act == 1) {  // the lane's only run: the output itself
    const float il = 1.f / l;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= il;
    store_cols<D>(o + (((long long)b * T + t) * H + h) * D, acc, gl);
    return;
  }
  const long long item = (((long long)b * n_splits + sp) * T + t) * H + h;
  float* wacc = ws + item * D;
#pragma unroll
  for (int i = 0; i < N; ++i) wacc[col<D>(gl, i)] = acc[i];
  if (gl == 0) {
    float* ml = ws + (long long)gridDim.z * n_splits * T * H * D + 2 * item;
    ml[0] = m;
    ml[1] = l;
  }
}

// o of every (b, t, h, column) whose lane took more than one run: the
// runs' (m, l, acc) combined in split order.  Launched while the split
// grid runs (programmatic dependent launch), it reads the lengths, then
// waits for that grid; every partial's load is then issued without
// waiting for the lane's length (runs past it are read and dropped)
template <int D>
__global__ void __launch_bounds__(256)
ragged_merge_kernel(const int* __restrict__ lengths,
                    const float* __restrict__ ws, bf16* __restrict__ o, int B,
                    int T, int H, int S, int W, int pps, int n_splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * T * H * D) return;
  const int d = (int)(i % D);
  long long r = i / D;
  const int h = (int)(r % H);
  r /= H;
  const int t = (int)(r % T), b = (int)(r / T);
  const int n_act = (included_pages(lengths[b], S, W) + pps - 1) / pps;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = ws + (long long)B * n_splits * T * H * D;
  float mx = -INFINITY, lsum = 0.f, out = 0.f;
  constexpr int BATCH = 8;  // runs whose loads are in flight at once
  for (int s0 = 0; s0 < n_splits; s0 += BATCH) {
    float m[BATCH], l[BATCH], a[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const long long it = (((long long)b * n_splits + s0 + j) * T + t) * H + h;
      const bool in = s0 + j < n_splits;
      m[j] = in ? ml[2 * it] : 0.f;
      l[j] = in ? ml[2 * it + 1] : 0.f;
      a[j] = in ? ws[it * D + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (s0 + j < n_act) {
        const float mn = fmaxf(mx, m[j]);
        const float f0 = expf(mx - mn), f1 = expf(m[j] - mn);
        lsum = lsum * f0 + l[j] * f1;
        out = out * f0 + a[j] * f1;
        mx = mn;
      }
    }
  }
  if (n_act > 1) o[i] = __float2bfloat16(out / lsum);
}

template <int D, int KS>
cudaError_t launch_ks(const int* rows, const int* lens, const void* q,
                      const void* kp, const void* vp, const int* qpos, void* o,
                      float* ws, int B, int T, int H, int P, int S, int W,
                      float scale, int pps, int n_splits, int hg,
                      cudaStream_t stream) {
  const size_t bytes = (size_t)STAGES * (2 * KS * hg * D * 2 + 8) +
                       (size_t)pps * 4;
  if (bytes > (size_t)SMEM_OPTIN) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_split_kernel<D, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(n_splits * T, (H + hg - 1) / hg, B);
  ragged_split_kernel<D, KS><<<grid, 32 * hg, bytes, stream>>>(
      rows, lens, static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), qpos, static_cast<bf16*>(o), ws, T, H, P,
      S, W, scale, pps, n_splits, hg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  // the merge grid, launched while the split grid runs; it waits for it
  // in griddepcontrol.wait
  const long long total = (long long)B * T * H * D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ragged_merge_kernel<D>, lens,
                            (const float*)ws, static_cast<bf16*>(o), B, T, H,
                            S, W, pps, n_splits);
}

template <int D>
cudaError_t launch(const int* rows, const int* lens, const void* q,
                   const void* kp, const void* vp, const int* qpos, void* o,
                   float* ws, int B, int T, int H, int P, int S, int W,
                   float scale, int pps, int n_splits, int hg, int ks,
                   cudaStream_t stream) {
  if (S % ks || hg < 1 || hg > MAX_HEADS || pps < 1 || n_splits < 1 ||
      (long long)n_splits * pps < W || (n_splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  switch (ks) {
    case 8:
      return launch_ks<D, 8>(rows, lens, q, kp, vp, qpos, o, ws, B, T, H, P,
                             S, W, scale, pps, n_splits, hg, stream);
    case 16:
      return launch_ks<D, 16>(rows, lens, q, kp, vp, qpos, o, ws, B, T, H, P,
                              S, W, scale, pps, n_splits, hg, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace split

// ---- tiled path -----------------------------------------------------------------

namespace tiled {

// shared memory: Q (flash_common's resident atoms, 64 rows used), the
// ring of K and V stages (two a warpgroup), the barriers, the stage
// counts, the warps' qpos min/max, then the row's page ids (W of them,
// and a tile's worth of zeros past W)
template <int D>
struct Tile : Geom<D> {
  using G = Geom<D>;
  static constexpr int NS = 4;  // stages: tiles kt, kt + 4, ... share one
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)G::NATOM * G::RES;
  static constexpr size_t V = K + (size_t)NS * G::TILE;
  static constexpr size_t BAR = V + (size_t)NS * G::TILE;
  static constexpr size_t PAGES = BAR + (NS + 1) * 8 + NS * 4 + 16 * 4;
  static size_t bytes(int W) { return PAGES + ((size_t)W + 8) * 4 + 1024; }
};

// the online softmax of one thread's two rows (r0 and r0 + 8 of the
// tile) over key tiles, each row masked at its own qpos
struct Softmax {
  int cq, qp0, qp1, qmin, n_keys;
  float scale;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // scores of the key tile at k0 to bf16 probabilities pa; returns the
  // factors (row r0, row r0 + 8) that rescale O
  __device__ __forceinline__ float2 tile(float* s, int k0, uint32_t (*pa)[4]) {
    const bool diag = k0 + BK - 1 > qmin;  // a key past some row's qpos
    const bool edge = k0 + BK > n_keys;    // keys of pages that take no part
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + cq + e;
        float v0 = s[4 * j + e] * scale;
        float v1 = s[4 * j + 2 + e] * scale;
        if (diag) {
          if (kpos > qp0) v0 = MASK_VALUE;
          if (kpos > qp1) v1 = MASK_VALUE;
        }
        if (edge && kpos >= n_keys) v0 = v1 = -INFINITY;
        s[4 * j + e] = v0;
        s[4 * j + 2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    // the tile holds an included key, so the new max is finite
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
        const float p0 = ex2((s[4 * j + e] - mn0) * LOG2E);
        const float p1 = ex2((s[4 * j + 2 + e] - mn1) * LOG2E);
        ls0 += p0;
        ls1 += p1;
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

// grid (ceil(T / 64), H, B), two warpgroups on the same 64 query rows:
// warpgroup c takes key tiles c, c + 2, ...; their softmax states are
// merged at the end through shared memory
template <int D>
__global__ void __launch_bounds__(256)
ragged_tiled_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const int* __restrict__ page_rows,
                    const int* __restrict__ lengths,
                    const int* __restrict__ qpos, bf16* __restrict__ o, int T,
                    int H, int P, int S, int W, float scale) {
  using TL = Tile<D>;
  constexpr int NS = TL::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BAR);
  uint64_t* qbar = full + NS;
  int* released = reinterpret_cast<int*>(qbar + 1);  // warps done, by stage
  int* red = released + NS;                          // qpos min/max by warp
  int* spage = reinterpret_cast<int*>(smem + TL::PAGES);

  const int h = blockIdx.y, b = blockIdx.z, t0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid / 32;
  const int c = warpgroup_index();
  const int tw = tid - 128 * c, lane = tw % 32;
  const int ppt = BK / S;  // pages a key tile

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
    mbar_expect_tx(qbar, BM * D * 2);
    for (int a = 0; a < TL::NATOM; ++a)
      tma_load_4d(smem + TL::Q + a * TL::RES, &tm_q, qbar, a * TL::ATOM, h, t0, b);
  }
  // the lane's length, qpos of the thread's rows and the row's page ids:
  // loads issued together, one round trip
  const int* row = page_rows + (long long)b * W;
  const int len = lengths[b];
  const int r0 = (tw / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of 64
  const int cq = (lane % 4) * 2;             // column in each 8-column group
  auto row_qpos = [&](int r) {               // past T: no causal mask
    return t0 + r < T ? qpos[(long long)b * T + t0 + r] : INT_MAX;
  };
  const int qp0 = row_qpos(r0), qp1 = row_qpos(r0 + 8);
  const int pid = tid < W ? row[tid] : 0;
  for (int i = tid; i < W + ppt; i += 256)
    spage[i] = i < W ? min(max(i == tid ? pid : row[i], 0), P - 1) : 0;
  const int n_pages = included_pages(len, S, W);
  // the tile's smallest and largest qpos over its rows < T
  const int lo = min(qp0, qp1);
  const int hi = max(t0 + r0 < T ? qp0 : INT_MIN, t0 + r0 + 8 < T ? qp1 : INT_MIN);
  const int wlo = __reduce_min_sync(0xffffffffu, lo);
  const int whi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    red[2 * warp] = wlo;
    red[2 * warp + 1] = whi;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < 4; ++w) {  // one warpgroup's warps cover the 64 rows
    qmin = min(qmin, red[2 * w]);
    qmax = max(qmax, red[2 * w + 1]);
  }
  const int n_keys = n_pages * S;
  int n_kt = (n_keys + BK - 1) / BK;
  // every row keeps key 0 (qpos >= 0): key tiles wholly past the largest
  // qpos add exp(MASK - m) == 0 and are skipped
  if (qmin >= 0) n_kt = min(n_kt, qmax / BK + 1);

  // K and V of key tile kt (its ppt pages) into stage st
  auto fill = [&](int st, int kt) {
    mbar_expect_tx(&full[st], 2 * TL::TILE);
    for (int j = 0; j < ppt; ++j) {
      const int page = spage[kt * ppt + j];
      for (int a = 0; a < TL::NATOM; ++a) {
        const int off = st * TL::TILE + (a * BK + j * S) * TL::ROWB;
        tma_load_4d(smem + TL::K + off, &tm_k, &full[st], a * TL::ATOM, h, 0, page);
        tma_load_4d(smem + TL::V + off, &tm_v, &full[st], a * TL::ATOM, h, 0, page);
      }
    }
  };
  if (tid == 0)
    for (int i = 0; i < NS && i < n_kt; ++i) fill(i, i);

  unsigned char* sq = smem + TL::Q;
  Softmax sm{cq, qp0, qp1, qmin, n_keys, scale};
  float oacc[D / 2];  // O: rows r0, r0 + 8 as an f32 accumulator
  float s[BK / 2];    // S of one key tile, then its probabilities
  // bf16 P of two tiles, in turns (as flash_fwd.cu)
  uint32_t pa[BK / 16][4], pb[BK / 16][4];
  mbar_wait(qbar, 0);
  int kt = c, st = c;  // this warpgroup's tile and its stage
  if (kt < n_kt) {
    mbar_wait(&full[st], 0);
    wgmma_fence();
    mma_rows_tile_t<D>(s, sq, smem + TL::K + st * TL::TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
    sm.tile(s, kt * BK, pa);
    // tile kt's O += P V beside tile kt+2's S and softmax
    auto step = [&](uint32_t (*cur)[4], uint32_t (*nxt)[4]) {
      const int nk = kt + 2, ns = nk % NS;
      mbar_wait(&full[ns], (nk / NS) & 1);
      wgmma_fence();
      mma_rows_tile_t<D>(s, sq, smem + TL::K + ns * TL::TILE);
      wgmma_commit();
      mma_regs_tile<D>(oacc, cur, smem + TL::V + st * TL::TILE, kt > c);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<BK / 2>(s);
      const float2 alpha = sm.tile(s, nk * BK, nxt);
      wgmma_wait<0>();
      fence_regs<D / 2>(oacc);
      // the stage's next tile (kt + NS) is this warpgroup's too
      release_stage(&released[st], 4, lane, [&]() {
        if (kt + NS < n_kt) fill(st, kt + NS);
      });
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= (i / 2) % 2 ? alpha.y : alpha.x;
      kt = nk;
      st = ns;
    };
    auto last = [&](uint32_t (*cur)[4]) {
      wgmma_fence();
      mma_regs_tile<D>(oacc, cur, smem + TL::V + st * TL::TILE, kt > c);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(oacc);
    };
    for (;;) {
      if (kt + 2 >= n_kt) { last(pa); break; }
      step(pa, pb);
      if (kt + 2 >= n_kt) { last(pb); break; }
      step(pb, pa);
    }
  }

  // warpgroup 1's (m, l, O) to warpgroup 0 through the spent ring, thread
  // by thread (the two hold the same rows and columns)
  __syncthreads();
  float* xch = reinterpret_cast<float*>(smem + TL::K);  // [D/2 + 4][128]
  const bool both = n_kt > 1;
  if (c == 1 && both) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) xch[i * 128 + tw] = oacc[i];
    xch[(D / 2) * 128 + tw] = sm.m0;
    xch[(D / 2 + 1) * 128 + tw] = sm.m1;
    xch[(D / 2 + 2) * 128 + tw] = sm.l0;
    xch[(D / 2 + 3) * 128 + tw] = sm.l1;
  }
  __syncthreads();
  if (c == 1) return;
  float l0 = sm.l0, l1 = sm.l1;
  if (both) {
    const float mb0 = xch[(D / 2) * 128 + tw], mb1 = xch[(D / 2 + 1) * 128 + tw];
    const float mx0 = fmaxf(sm.m0, mb0), mx1 = fmaxf(sm.m1, mb1);
    const float fa0 = ex2((sm.m0 - mx0) * LOG2E), fb0 = ex2((mb0 - mx0) * LOG2E);
    const float fa1 = ex2((sm.m1 - mx1) * LOG2E), fb1 = ex2((mb1 - mx1) * LOG2E);
    l0 = l0 * fa0 + xch[(D / 2 + 2) * 128 + tw] * fb0;
    l1 = l1 * fa1 + xch[(D / 2 + 3) * 128 + tw] * fb1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const bool r1 = (i / 2) % 2;
      oacc[i] = oacc[i] * (r1 ? fa1 : fa0) + xch[i * 128 + tw] * (r1 ? fb1 : fb0);
    }
  }
  // o = O / l through the Q rows (no longer read)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  stage_acc<D>(sq, oacc, r0, cq, 1.f / l0, 1.f / l1);
  named_barrier(1, 128);
  store_rows<D>(sq, o, b, h, H, T, t0, tw);
}

template <int D>
cudaError_t launch(const int* rows, const int* lens, const void* q,
                   const void* kp, const void* vp, const int* qpos, void* o,
                   int B, int T, int H, int P, int S, int W, float scale,
                   cudaStream_t stream) {
  if (BK % S) return cudaErrorInvalidValue;
  const size_t bytes = Tile<D>::bytes(W);
  if (bytes > (size_t)SMEM_OPTIN) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const long long qst[3] = {(long long)T * H * D, (long long)H * D, D};
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)P};
  const uint64_t strides[3] = {(uint64_t)D, (uint64_t)H * D, (uint64_t)S * H * D};
  const uint32_t box[4] = {(uint32_t)Geom<D>::ATOM, 1, (uint32_t)S, 1};
  if (!map_bshd<D>(&maps[0], q, B, T, H, qst, BM) ||
      !map_4d(&maps[1], kp, dims, strides, box, tma_swizzle<D>()) ||
      !map_4d(&maps[2], vp, dims, strides, box, tma_swizzle<D>()))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_tiled_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_OPTIN);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((T + BM - 1) / BM, H, B);
  ragged_tiled_kernel<D><<<grid, 256, bytes, stream>>>(
      maps[0], maps[1], maps[2], rows, lens, qpos, static_cast<bf16*>(o), T, H,
      P, S, W, scale);
  return cudaGetLastError();
}

}  // namespace tiled

template <int D>
cudaError_t run(const int* rows, const int* lens, const void* q, const void* kp,
                const void* vp, const int* qpos, void* o, float* ws, int B,
                int T, int H, int P, int S, int W, float scale, int path,
                int pps, int n_splits, int hg, int ks, cudaStream_t stream) {
  return path == 1
             ? tiled::launch<D>(rows, lens, q, kp, vp, qpos, o, B, T, H, P, S,
                                W, scale, stream)
             : split::launch<D>(rows, lens, q, kp, vp, qpos, o, ws, B, T, H, P,
                                S, W, scale, pps, n_splits, hg, ks, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// path 0: the split path (pps pages a CTA, n_splits runs, hg heads a
// group, ks = 8 or 16 keys a stage; ws: B * n_splits * T * H * (D + 2)
// f32, or null with one run); path 1: the tiled path (the last four
// unread)
int ragged_paged_bf16(const void* page_rows, const void* lengths,
                      const void* q, const void* k_pages,
                      const void* v_pages, const void* qpos, void* o,
                      void* ws, int B, int T, int H, int D, int P, int S,
                      int W, float scale, int path, int pps, int n_splits,
                      int hg, int ks, void* stream) {
  const int* rows = static_cast<const int*>(page_rows);
  const int* lens = static_cast<const int*>(lengths);
  const int* qp = static_cast<const int*>(qpos);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S % 8 != 0 || T < 1 || W < 1 || B < 1 || H < 1 || P < 1 ||
      (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return run<16>(rows, lens, q, k_pages, v_pages, qp, o, w, B, T, H, P, S,
                     W, scale, path, pps, n_splits, hg, ks, s);
    case 32:
      return run<32>(rows, lens, q, k_pages, v_pages, qp, o, w, B, T, H, P, S,
                     W, scale, path, pps, n_splits, hg, ks, s);
    case 64:
      return run<64>(rows, lens, q, k_pages, v_pages, qp, o, w, B, T, H, P, S,
                     W, scale, path, pps, n_splits, hg, ks, s);
    case 128:
      return run<128>(rows, lens, q, k_pages, v_pages, qp, o, w, B, T, H, P, S,
                      W, scale, path, pps, n_splits, hg, ks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
