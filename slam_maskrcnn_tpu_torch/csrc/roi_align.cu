// PyramidROIAlign: FPN level routing + bilinear crop-and-resize, one thread
// per output element (roi, p, q, c) with c fastest.
//
// Replaces the TPU kernel `_roi_align_kernel` (slam_maskrcnn_tpu/ops/
// pallas/roi_align_kernel.py, reached through pyramid_roi_align_pallas).
// Semantics are those of the exact oracle ops/roi_align.pyramid_roi_align:
// each roi goes to P2..P5 by roi_level (round half to even), samples
// pool x pool points over the TRUE level extent with tf.image.
// crop_and_resize's grid, and reads 0 outside the level. A gather needs
// neither the TPU kernel's 48-cell rect nor its clamped-sample count.
//
// Features are NHWC in the trunk's dtype (f32 or bf16); sums and the
// output are f32.
//
// Bound on an H100: memory. Every output element reads four feature
// values; consecutive threads are consecutive channels of the same corner
// pixels, so a warp reads 4 contiguous 64-128 B runs and writes one
// contiguous 128 B run.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct Pyramid {
  const void* feat[4];
  int h[4], w[4];
};

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void roi_align_kernel(Pyramid pyr, const float* __restrict__ boxes,
                                 int n, int pool, int C, float level_denom,
                                 float* __restrict__ out) {
  const long long total = (long long)n * pool * pool * C;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % C);
  long long r_ = t / C;
  const int q = (int)(r_ % pool);
  r_ /= pool;
  const int p = (int)(r_ % pool);
  const int r = (int)(r_ / pool);

  const float y1 = boxes[r * 4 + 0], x1 = boxes[r * 4 + 1];
  const float y2 = boxes[r * 4 + 2], x2 = boxes[r * 4 + 3];

  // roi_level: 4 + round(log2(sqrt(h*w) / (224 / sqrt(image area))))
  const float scale = sqrtf(fmaxf((y2 - y1) * (x2 - x1), 1e-12f)) / level_denom;
  float lvl = 4.0f + rintf(log2f(fmaxf(scale, 1e-12f)));
  lvl = fminf(fmaxf(lvl, 2.0f), 5.0f);
  const int li = (int)lvl - 2;
  const int H = pyr.h[li], W = pyr.w[li];
  const float hm1 = (float)(H - 1), wm1 = (float)(W - 1);

  float ys, xs;
  if (pool > 1) {
    ys = y1 * hm1 + (float)p * ((y2 - y1) * hm1 / (float)(pool - 1));
    xs = x1 * wm1 + (float)q * ((x2 - x1) * wm1 / (float)(pool - 1));
  } else {
    ys = 0.5f * (y1 + y2) * hm1;
    xs = 0.5f * (x1 + x2) * wm1;
  }
  float res = 0.0f;
  if (ys >= 0.0f && ys <= hm1 && xs >= 0.0f && xs <= wm1) {
    const float y0 = floorf(ys), x0 = floorf(xs);
    const float wy = ys - y0, wx = xs - x0;
    const int yi = (int)y0, xi = (int)x0;
    const int ya = min(max(yi, 0), H - 1), yb = min(max(yi + 1, 0), H - 1);
    const int xa = min(max(xi, 0), W - 1), xb = min(max(xi + 1, 0), W - 1);
    const T* f = (const T*)pyr.feat[li];
    const float c00 = load_f(f, ((long long)ya * W + xa) * C + c);
    const float c01 = load_f(f, ((long long)ya * W + xb) * C + c);
    const float c10 = load_f(f, ((long long)yb * W + xa) * C + c);
    const float c11 = load_f(f, ((long long)yb * W + xb) * C + c);
    const float top = c00 * (1.0f - wx) + c01 * wx;
    const float bot = c10 * (1.0f - wx) + c11 * wx;
    res = top * (1.0f - wy) + bot * wy;
  }
  out[t] = res;
}

static int launch(bool bf16, const void* const* feats, const int* hw,
                  const float* boxes, int n, int pool, int C,
                  float level_denom, float* out, void* stream) {
  Pyramid pyr;
  for (int l = 0; l < 4; ++l) {
    pyr.feat[l] = feats[l];
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
  }
  const long long total = (long long)n * pool * pool * C;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (bf16)
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
        pyr, boxes, n, pool, C, level_denom, out);
  else
    roi_align_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pyr, boxes, n, pool, C, level_denom, out);
  return (int)cudaGetLastError();
}

extern "C" int roi_align_cuda(int bf16, const void* f0, const void* f1,
                              const void* f2, const void* f3, const int* hw,
                              const float* boxes, int n, int pool, int C,
                              float level_denom, float* out, void* stream) {
  const void* feats[4] = {f0, f1, f2, f3};
  return launch(bf16 != 0, feats, hw, boxes, n, pool, C, level_denom, out,
                stream);
}
