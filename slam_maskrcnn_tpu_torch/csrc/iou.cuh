// The IoU test of greedy NMS, shared by csrc/nms.cu and csrc/nms_sorted.cu
// so that both kernels take every decision the same way.
#pragma once

#include <cuda_runtime.h>

// The band around the threshold t inside which the quotient decides:
// t widened by 8 ulp either way; +inf and -inf for a threshold too small
// for the band to be safe (then every pair divides).
struct IouBand {
  float t, hi, lo;
};

__device__ __forceinline__ IouBand iou_band(float t) {
  const bool banded = t >= 1e-6f;
  return {t, banded ? t * 1.000001f : INFINITY,
          banded ? t * 0.999999f : -INFINITY};
}

// iou > t for iou = inter / u, u = max(uni, 1e-10f), the plain version's
// (ops/boxes.compute_iou_matrix), in three parts: surely below, surely
// above, and the division that decides a quotient within a few ulp of t
// (or one with a NaN, which neither compare claims).
__device__ __forceinline__ float iou_denominator(float uni) {
  return fmaxf(uni, 1e-10f);
}
__device__ __forceinline__ bool iou_surely_below(float inter, float u,
                                                 IouBand band) {
  return inter < band.lo * u;
}
__device__ __forceinline__ bool iou_surely_above(float inter, float u,
                                                 IouBand band) {
  return inter > band.hi * u;
}
__device__ __forceinline__ bool iou_divided_above(float inter, float u,
                                                  IouBand band) {
  return inter / u > band.t;
}

// The whole test; nearly every pair leaves at the first compare.
__device__ __forceinline__ bool iou_above(float inter, float uni,
                                          IouBand band) {
  const float u = iou_denominator(uni);
  if (__builtin_expect(iou_surely_below(inter, u, band), 1)) return false;
  return iou_surely_above(inter, u, band) || iou_divided_above(inter, u, band);
}

// intersection area of two (y1, x1, y2, x2) boxes, in the plain version's
// order of operations
__device__ __forceinline__ float box_inter(float4 a, float4 b) {
  const float iy1 = fmaxf(a.x, b.x), ix1 = fmaxf(a.y, b.y);
  const float iy2 = fminf(a.z, b.z), ix2 = fminf(a.w, b.w);
  return fmaxf(iy2 - iy1, 0.f) * fmaxf(ix2 - ix1, 0.f);
}

__device__ __forceinline__ float box_area(float4 a) {
  return (a.z - a.x) * (a.w - a.y);
}
