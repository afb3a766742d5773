// The element pass of the FFN's library arm, forward and backward, for
// Hopper (sm_90a): bf16 or f32 in and out, f32 in registers.
//
// It replaces no Pallas kernel.  paddle_tpu/ops/pallas/ffn.py::fused_ffn
// runs plain XLA dots unless its kernel is opted in (:506-516), and XLA
// fuses the bias, the activation and the `_ffn_keep` hash dropout between
// the two dots into one elementwise pass.  These two kernels are that
// pass for the port's library arm (ops/kernels/ffn.py::FFNLibraryFunction),
// whose products are cuBLAS:
//
//   ffn_act_fwd:  h    = drop(act(pre + b1))
//   ffn_act_bwd:  dpre = drop(dh) * act'(pre + b1),  and h again
//
// where drop(v) = keep(seed, t, c) ? v / (1 - p) : v's zero, t the token
// row and c the d_ff column from origin (0, 0), and keep the `_ffn_keep`
// hash bit for bit.  pre, dh, h, dpre: (T, F), contiguous; b1: (F); all
// of one type (bf16 on the model path; f32 too, which the FFN kernels
// do not take).  act is gelu (the Abramowitz-Stegun erf of
// paddle_tpu's `_erf`), gelu_tanh or relu; every value is rounded to its
// type once, at the store.
//
// Bound on the H100: bytes.  The forward reads pre and writes h, 2 x T x F
// x 2 bytes (100.7 MB each at T=16384, F=3072: 0.060 ms at 3.35 TB/s);
// the backward reads pre and dh and writes dpre and h, 4 x T x F x 2.
// A handful of flops an element is far below the card's 295 per byte.
//
// Design: the simplest kernel that moves each byte once.  One thread per
// 16 bytes of values (8 bf16, 4 f32): 16-byte loads of pre (and
// dh) and of as many bias values, 16-byte stores.  When F is a whole
// number of such vectors and every pointer is 16-byte aligned (always, for
// the wrapper's fresh tensors), a vector lies in one row, whose row and
// column come from one division; otherwise each value is loaded, placed
// and stored on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_common.cuh"

namespace {

constexpr int THREADS = 256;

struct Drop {
  uint32_t seed, thresh;
  float keep;     // 1 - p, the divisor of a kept value
  uint32_t col0;  // the hash's first column (a tensor-parallel rank's)
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f32(float v) {
  return v;
}

// values of T in 16 bytes
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int ACT, bool DROP>
__device__ __forceinline__ float fwd_value(float pre, float b, uint32_t t,
                                           uint32_t c, const Drop& d) {
  const float a = ffn::act<ACT>(pre + b);
  if (!DROP) return a;
  return ffn::keep_hash(d.seed, t, c + d.col0) >= d.thresh ? a / d.keep : 0.f;
}

// dpre, and the forward's value into *h
template <int ACT, bool DROP>
__device__ __forceinline__ float bwd_value(float pre, float b, float dh,
                                           uint32_t t, uint32_t c,
                                           const Drop& d, float* h) {
  const float x = pre + b;
  float a = ffn::act<ACT>(x);
  if (DROP) {
    const bool kept = ffn::keep_hash(d.seed, t, c + d.col0) >= d.thresh;
    dh = kept ? dh / d.keep : 0.f;
    a = kept ? a / d.keep : 0.f;
  }
  *h = a;
  return dh * ffn::act_grad<ACT>(x);
}

template <typename T, int ACT, bool DROP, bool VEC>
__global__ void __launch_bounds__(THREADS)
    ffn_act_fwd_kernel(const T* __restrict__ pre, const T* __restrict__ b1,
                       T* __restrict__ h, long long n, int f, Drop d) {
  constexpr int N = kVec<T>;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * N;
  if (i0 >= n) return;
  if (VEC) {
    const uint32_t t = static_cast<uint32_t>(i0 / f);
    const int c0 = static_cast<int>(i0 - static_cast<long long>(t) * f);
    const uint4 praw = load16(pre + i0), braw = load16(b1 + c0);
    const T* p = reinterpret_cast<const T*>(&praw);
    const T* b = reinterpret_cast<const T*>(&braw);
    uint4 oraw;
    T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
    for (int e = 0; e < N; ++e)
      o[e] = from_f32<T>(
          fwd_value<ACT, DROP>(to_f32(p[e]), to_f32(b[e]), t, c0 + e, d));
    *reinterpret_cast<uint4*>(h + i0) = oraw;
  } else {
    for (int e = 0; e < N && i0 + e < n; ++e) {
      const long long i = i0 + e;
      const uint32_t t = static_cast<uint32_t>(i / f);
      const int c = static_cast<int>(i - static_cast<long long>(t) * f);
      h[i] = from_f32<T>(
          fwd_value<ACT, DROP>(to_f32(pre[i]), to_f32(b1[c]), t, c, d));
    }
  }
}

template <typename T, int ACT, bool DROP, bool VEC>
__global__ void __launch_bounds__(THREADS)
    ffn_act_bwd_kernel(const T* __restrict__ pre, const T* __restrict__ b1,
                       const T* __restrict__ dh, T* __restrict__ dpre,
                       T* __restrict__ h, long long n, int f, Drop d) {
  constexpr int N = kVec<T>;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * N;
  if (i0 >= n) return;
  if (VEC) {
    const uint32_t t = static_cast<uint32_t>(i0 / f);
    const int c0 = static_cast<int>(i0 - static_cast<long long>(t) * f);
    const uint4 praw = load16(pre + i0), braw = load16(b1 + c0),
                graw = load16(dh + i0);
    const T* p = reinterpret_cast<const T*>(&praw);
    const T* b = reinterpret_cast<const T*>(&braw);
    const T* g = reinterpret_cast<const T*>(&graw);
    uint4 oraw, hraw;
    T* o = reinterpret_cast<T*>(&oraw);
    T* oh = reinterpret_cast<T*>(&hraw);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float hv;
      o[e] = from_f32<T>(bwd_value<ACT, DROP>(
          to_f32(p[e]), to_f32(b[e]), to_f32(g[e]), t, c0 + e, d, &hv));
      oh[e] = from_f32<T>(hv);
    }
    *reinterpret_cast<uint4*>(dpre + i0) = oraw;
    *reinterpret_cast<uint4*>(h + i0) = hraw;
  } else {
    for (int e = 0; e < N && i0 + e < n; ++e) {
      const long long i = i0 + e;
      const uint32_t t = static_cast<uint32_t>(i / f);
      const int c = static_cast<int>(i - static_cast<long long>(t) * f);
      float hv;
      dpre[i] = from_f32<T>(bwd_value<ACT, DROP>(
          to_f32(pre[i]), to_f32(b1[c]), to_f32(dh[i]), t, c, d, &hv));
      h[i] = from_f32<T>(hv);
    }
  }
}

unsigned int blocks_for(long long n, int per_thread) {
  const long long per_block = static_cast<long long>(THREADS) * per_thread;
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One launch of the forward (dh == nullptr) or the backward, at the
// instantiation the call needs.
template <typename T, int ACT, bool DROP, bool VEC>
void launch(const void* pre, const void* b1, const void* dh, void* out,
            void* h, long long n, int f, Drop d, cudaStream_t s) {
  const unsigned int grid = blocks_for(n, kVec<T>);
  if (dh == nullptr)
    ffn_act_fwd_kernel<T, ACT, DROP, VEC><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(pre), static_cast<const T*>(b1),
        static_cast<T*>(out), n, f, d);
  else
    ffn_act_bwd_kernel<T, ACT, DROP, VEC><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(pre), static_cast<const T*>(b1),
        static_cast<const T*>(dh), static_cast<T*>(out),
        static_cast<T*>(h), n, f, d);
}

template <typename T, int ACT>
void launch_act(bool drop, bool vec, const void* pre, const void* b1,
                const void* dh, void* out, void* h, long long n, int f,
                Drop d, cudaStream_t s) {
  if (drop)
    (vec ? launch<T, ACT, true, true> : launch<T, ACT, true, false>)(
        pre, b1, dh, out, h, n, f, d, s);
  else
    (vec ? launch<T, ACT, false, true> : launch<T, ACT, false, false>)(
        pre, b1, dh, out, h, n, f, d, s);
}

template <typename T>
int run(const void* pre, const void* b1, const void* dh, void* out, void* h,
        long long T_, int F, int act_id, int drop, unsigned int thresh,
        float keep_prob, unsigned int seed, int col0, void* stream) {
  if (T_ < 0 || F < 1 || (dh != nullptr && h == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n = T_ * F;
  if (n == 0) return 0;
  const bool vec = F % kVec<T> == 0 && aligned16(pre) && aligned16(b1) &&
                   aligned16(out) &&
                   (dh == nullptr || (aligned16(dh) && aligned16(h)));
  const Drop d{seed, thresh, keep_prob, (uint32_t)col0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act_id) {
    case ffn::ACT_GELU:
      launch_act<T, ffn::ACT_GELU>(drop != 0, vec, pre, b1, dh, out, h, n, F,
                                   d, s);
      break;
    case ffn::ACT_GELU_TANH:
      launch_act<T, ffn::ACT_GELU_TANH>(drop != 0, vec, pre, b1, dh, out, h,
                                        n, F, d, s);
      break;
    case ffn::ACT_RELU:
      launch_act<T, ffn::ACT_RELU>(drop != 0, vec, pre, b1, dh, out, h, n, F,
                                   d, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype ids, as the wrapper passes them
enum { DT_BF16 = 0, DT_F32 = 1 };

int run_dtype(int dtype, const void* pre, const void* b1, const void* dh,
              void* out, void* h, long long T_, int F, int act_id, int drop,
              unsigned int thresh, float keep_prob, unsigned int seed,
              int col0, void* stream) {
  switch (dtype) {
    case DT_BF16:
      return run<__nv_bfloat16>(pre, b1, dh, out, h, T_, F, act_id, drop,
                                thresh, keep_prob, seed, col0, stream);
    case DT_F32:
      return run<float>(pre, b1, dh, out, h, T_, F, act_id, drop, thresh,
                        keep_prob, seed, col0, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 bf16, 1 f32 (every operand).  act_id: 0 gelu (A-S
// erf), 1 gelu_tanh, 2 relu.  drop: 1 when p > 0; a value is then kept
// where the hash is >= drop_thresh and divided by keep_prob = 1 - p; the
// hash takes column c as col0 + c (a tensor-parallel rank's d_ff columns).
// T x F values; one launch.
int ffn_act_fwd(int dtype, const void* pre, const void* b1, void* h,
                long long T, int F, int act_id, int drop,
                unsigned int drop_thresh, float keep_prob, unsigned int seed,
                int col0, void* stream) {
  return run_dtype(dtype, pre, b1, nullptr, h, nullptr, T, F, act_id, drop,
                   drop_thresh, keep_prob, seed, col0, stream);
}

// The gradient: dpre from pre, b1 and dh, and h (the forward's output,
// recomputed) in the same pass.
int ffn_act_bwd(int dtype, const void* pre, const void* b1, const void* dh,
                void* dpre, void* h, long long T, int F, int act_id,
                int drop, unsigned int drop_thresh, float keep_prob,
                unsigned int seed, int col0, void* stream) {
  if (dh == nullptr) return (int)cudaErrorInvalidValue;
  return run_dtype(dtype, pre, b1, dh, dpre, h, T, F, act_id, drop,
                   drop_thresh, keep_prob, seed, col0, stream);
}

}  // extern "C"
