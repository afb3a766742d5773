// Pieces shared by the flash-attention kernels (flash_fwd.cu, and both
// passes of flash_bwd.cu): the tile geometry, the _keep_mask3 dropout
// hash, the two wgmma forms every pass is built from, the bf16 epilogue
// through shared memory, and the 4-D tensor maps over (B, S, H, D).
//
// A CTA holds NC = 1 or 2 warpgroups of 64 rows each (queries in the
// forward and the dq pass, keys in the dkv pass).  Those rows stay in
// shared memory for the whole call ("resident": Q, or K and V, or Q and
// G), kept as NATOM atoms of up to 64 columns, each atom MAX_NC * 64 rows
// long.  The other side streams through a ring of 64-row tiles with the
// same swizzled row layout, so one tile serves as a K-major B operand
// (S = rows x tile^T) and as an MN-major B operand (acc += A x tile).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;     // rows a warpgroup owns
constexpr int BK = 64;     // rows of a streamed tile
constexpr int NST = 3;     // ring stages
constexpr int MAX_NC = 2;  // warpgroups a CTA holds at most
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geom {
  static constexpr int ATOM = D < 64 ? D : 64;  // elements a swizzled row holds
  static constexpr int NATOM = D / ATOM;        // 1, or 2 at D=128
  static constexpr int ROWB = ATOM * 2;         // bytes of a swizzled row
  static constexpr int GROUP = 8 * ROWB;        // 8-row group (SBO)
  static constexpr uint32_t LAYOUT = D == 16 ? SW32 : D == 32 ? SW64 : SW128;
  static constexpr int RES = MAX_NC * BM * ROWB;  // bytes of a resident atom
  static constexpr int TILE = BK * D * 2;         // bytes of a streamed tile
  static_assert(TILE % 1024 == 0 && RES % 1024 == 0, "swizzle alignment");
};

template <int D>
CUtensorMapSwizzle tma_swizzle() {
  return D == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
       : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the max and the sum over the four threads of a row of an accumulator
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (64 x BK, f32) = the warpgroup's 64 resident rows (rows: atoms RES
// apart) times a streamed tile (tile: atoms BK rows apart)^T, both
// K-major: Q K^T and G V^T in the forward and the dq pass, K Q^T and
// V G^T in the dkv pass
template <int D>
__device__ __forceinline__ void mma_rows_tile_t(float* s,
                                                const unsigned char* rows,
                                                const unsigned char* tile) {
  using G = Geom<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int atom = kk * 16 / G::ATOM, in_row = (kk * 16 % G::ATOM) * 2;
    wgmma_n64<0, 0>(s, desc(rows + atom * G::RES + in_row, 16, G::GROUP,
                            G::LAYOUT),
                    desc(tile + atom * BK * G::ROWB + in_row, 16, G::GROUP,
                         G::LAYOUT),
                    kk > 0);
  }
}

template <int D>
__device__ __forceinline__ void mma_rs(float* o, const uint32_t* a,
                                       uint64_t db, int scale_d) {
  if constexpr (D == 16) wgmma_rs_n16<1>(o, a, db, scale_d);
  else if constexpr (D == 32) wgmma_rs_n32<1>(o, a, db, scale_d);
  else if constexpr (D == 64) wgmma_rs_n64<1>(o, a, db, scale_d);
  else wgmma_rs_n128<1>(o, a, db, scale_d);
}

// O (64 x D, f32) += A (64 x BK: BK/16 register A fragments, acc_to_a)
// times a streamed tile (64 x D) read MN-major: P V in the forward, dS K
// in the dq pass, P~^T G and dS^T Q in the dkv pass; `accumulate` 0
// starts O
template <int D>
__device__ __forceinline__ void mma_regs_tile(float* o, uint32_t (*a)[4],
                                              const unsigned char* tile,
                                              bool accumulate) {
  using G = Geom<D>;
  const uint64_t dt = desc(tile, BK * G::ROWB, G::GROUP, G::LAYOUT);
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    mma_rs<D>(o, a[j], dt + ((j * 16 * G::ROWB) >> 4), accumulate || j > 0);
}

// byte offset of element (row, col) of a 64 x D bf16 tile kept in the
// atoms of a warpgroup's resident rows, with 16-byte chunks of a row
// permuted by the row (the epilogue's staging layout)
template <int D>
__device__ __forceinline__ int stage_off(int row, int col) {
  using G = Geom<D>;
  constexpr int CH = G::ROWB / 16;
  return (col / G::ATOM) * G::RES + row * G::ROWB +
         ((((col % G::ATOM) / 8) ^ (row % CH)) * 16) + (col % 8) * 2;
}

// a thread's part of a 64 x D f32 accumulator (rows r0 and r0 + 8,
// columns 8j + cq + {0, 1}) as bf16 into the staging layout at st, row
// r0 times f0 and row r0 + 8 times f1
template <int D>
__device__ __forceinline__ void stage_acc(unsigned char* st, const float* acc,
                                          int r0, int cq, float f0, float f1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq;
    *reinterpret_cast<__nv_bfloat162*>(st + stage_off<D>(r0, col)) =
        __floats2bfloat162_rn(acc[4 * j] * f0, acc[4 * j + 1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(st + stage_off<D>(r0 + 8, col)) =
        __floats2bfloat162_rn(acc[4 * j + 2] * f1, acc[4 * j + 3] * f1);
  }
}

// the staged 64 x D tile at st as rows row0 .. row0 + 63 (those < S) of
// head h, batch b of a contiguous (B, S, H, D) bf16 output, 16 bytes a
// thread a step; tw: the thread's index in its warpgroup
template <int D>
__device__ __forceinline__ void store_rows(const unsigned char* st, bf16* out,
                                           int b, int h, int H, int S,
                                           int row0, int tw) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  for (int i = tw; i < BM * CH; i += 128) {
    const int r = i / CH, ch = i % CH;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(out + (((long long)b * S + row0 + r) * H + h) *
                                          D + ch * 8) =
          *reinterpret_cast<const uint4*>(st + stage_off<D>(r, ch * 8));
  }
}

// the warp is done with a ring stage: the last of the CTA's `nwarps`
// warps to say so resets the stage's count and runs `refill` (no
// producer warp: its registers would count against every thread's at
// launch)
template <class Refill>
__device__ __forceinline__ void release_stage(int* count, int nwarps, int lane,
                                              Refill refill) {
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    if (atomicAdd(count, 1) == nwarps - 1) {
      __threadfence_block();
      *count = 0;
      refill();
    }
  }
}

// a bf16 (B, S, H, D) tensor with element strides st[0..2] = (batch, seq,
// head), read in boxes of `rows` sequence rows of one head, one swizzled
// atom of columns at a time (rows past S arrive as zeros)
template <int D>
bool map_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H,
              const long long* st, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)st[2], (uint64_t)st[1],
                               (uint64_t)st[0]};
  const uint32_t box[4] = {(uint32_t)Geom<D>::ATOM, 1, (uint32_t)rows, 1};
  return map_4d(map, ptr, dims, strides, box, tma_swizzle<D>());
}

}  // namespace flash
