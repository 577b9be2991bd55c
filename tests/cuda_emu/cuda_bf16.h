// CPU emulation of the bf16 type and conversions the kernels use.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t bits;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return __nv_bfloat16{static_cast<uint16_t>((u >> 16) | 0x40)};
  return __nv_bfloat16{
      static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}

inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return float2{__bfloat162float(h.x), __bfloat162float(h.y)};
}
