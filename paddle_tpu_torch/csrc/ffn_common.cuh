// The FFN kernels' shared element math: the dropout hash, the activations
// and their gradients, as paddle_tpu/ops/pallas/ffn.py computes them.

#pragma once

#include <stdint.h>

namespace ffn {

enum { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_RELU = 2 };

// paddle_tpu/ops/pallas/ffn.py::_ffn_keep, bit for bit
__device__ __forceinline__ uint32_t keep_hash(uint32_t seed, uint32_t r,
                                              uint32_t c) {
  uint32_t x = (r * 0x9E3779B1u) ^ (c * 0x85EBCA77u);
  x ^= seed * 0x165667B1u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// paddle_tpu/ops/pallas/ffn.py::_erf (Abramowitz-Stegun 7.1.26)
__device__ __forceinline__ float as_erf(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float s = (float)((x > 0.f) - (x < 0.f));
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  return s * (1.0f - poly * expf(-ax * ax));
}

template <int ACT>
__device__ __forceinline__ float act(float h) {
  if (ACT == ACT_GELU) return h * 0.5f * (1.0f + as_erf(h * 0.7071067811865476f));
  if (ACT == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return h * (0.5f * (1.0f + tanhf(c * (h + 0.044715f * (h * h * h)))));
  }
  return fmaxf(h, 0.f);
}

// paddle_tpu/ops/pallas/ffn.py::_act_grad, with one exponential per
// element (A-S erf's exp(-x^2/2) is the pdf's), the hardware's fast exp
// and reciprocal, and tanh from one exp: the dx pass's dpre epilogue does
// not overlap the tensor pipe, and with accurate expf and division it took
// longer than that kernel's products (a throwaway variant without act' on
// the card).  The results differ from the accurate ones by a few f32
// units, far below the bf16 rounding of the dpre they feed.
template <int ACT>
__device__ __forceinline__ float act_grad(float h) {
  if (ACT == ACT_GELU) {
    const float e = __expf(-0.5f * h * h);
    const float ax = fabsf(h) * 0.7071067811865476f;
    const float t = __frcp_rn(1.0f + 0.3275911f * ax);
    const float poly =
        t * (0.254829592f +
             t * (-0.284496736f +
                  t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
    const float erf_ax = 1.0f - poly * e;  // erf(|h| / sqrt 2)
    const float cdf = 0.5f * (1.0f + (h < 0.f ? -erf_ax : erf_ax));
    return cdf + h * 0.3989422804014327f * e;
  }
  if (ACT == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;
    const float u = c * (h + 0.044715f * (h * h * h));
    const float t = 1.0f - 2.0f * __frcp_rn(__expf(2.0f * u) + 1.0f);  // tanh u
    return 0.5f * (1.0f + t) +
           0.5f * h * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * h * h);
  }
  return h > 0.f ? 1.f : 0.f;
}

}  // namespace ffn
