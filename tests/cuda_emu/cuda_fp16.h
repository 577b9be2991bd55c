// CPU emulation of the fp16 type and conversions the kernels use.  The
// conversions go through the compiler's _Float16, which rounds to nearest
// even as the card's __float2half_rn does.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_runtime.h"

struct __half {
  uint16_t bits;
};
struct __half2 {
  __half x, y;
};

inline float __half2float(__half h) {
  _Float16 v;
  std::memcpy(&v, &h.bits, 2);
  return static_cast<float>(v);
}

inline __half __float2half_rn(float f) {
  const _Float16 v = static_cast<_Float16>(f);
  __half h;
  std::memcpy(&h.bits, &v, 2);
  return h;
}

inline float2 __half22float2(__half2 h) {
  return float2{__half2float(h.x), __half2float(h.y)};
}
