// PyramidROIAlign: FPN level routing + bilinear crop-and-resize for a batch
// of images in one launch.
//
// Replaces the TPU kernel `_roi_align_kernel` (slam_maskrcnn_tpu/ops/
// pallas/roi_align_kernel.py, reached through pyramid_roi_align_pallas).
// Semantics are those of the exact oracle ops/roi_align.pyramid_roi_align:
// each roi goes to P2..P5 by roi_level (round half to even), samples
// pool x pool points over the TRUE level extent with tf.image.
// crop_and_resize's grid, and reads 0 outside the level. A gather needs
// neither the TPU kernel's 48-cell rect nor its clamped-sample count.
//
// Features are NHWC in the trunk's dtype (f32 or bf16), one [B, H_l, W_l, C]
// tensor per level; boxes [B, N, 4]; the output f32 [B, N, pool, pool, C].
//
// Bound on an H100: memory. The f32 output (50 MB an image at pool 7, 1000
// rois, C = 256) outweighs the pyramid it reads (33 MB in bf16), and the
// rois' corner reads come again and again from the same cells. The design:
// - One block per (image, roi, slice of the sample points), image-major, so
//   an image's pyramid stays in the 50 MB L2 while its rois run. Thread 0
//   routes the roi once (level, its base pointer, sample origin and step)
//   into shared memory; the first 2 * pool threads then fill a table of
//   the sample rows and columns (clamped corner indices, weights,
//   inside-the-level flags) there.
// - Threads along channels with 16-byte loads: 8 bf16 or 4 f32 channels a
//   thread, so one warp covers a sample point's 256 bf16 channels with four
//   512-byte corner reads and writes 1 KB of output in float4 stores. The
//   block's rows of threads take the sample points in turn.
// - The arithmetic is the plain version's, operation for operation (the
//   sample grid of crop_and_resize, the two-stage blend), and the build
//   uses --fmad=false: kernel and plain version agree bit for bit.
// - No 64-bit division: a thread splits the block index and finds its
//   first sample point with 32-bit divisions. The grid step and the level
//   scale are multiplications by f32 reciprocals, as XLA compiles the
//   reference's divisions by constants.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_POOL 64
#define ROI_THREADS 256
#define MIN_BLOCKS 528  // 4 blocks of 256 threads on each of the 132 SMs

struct Pyramid {
  const void* feat[4];
  int h[4], w[4];
};

// 16 bytes of channels -> float, as the plain version's .float()
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the high half of its float
      v[2 * k] = __uint_as_float(u[k] << 16);
      v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
};

template <typename V>
__device__ __forceinline__ V pick(const V (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// One sample row (or column) of a roi: the two clamped corner indices, the
// fractional weight, and whether the sample lies inside the level.
struct Axis {
  int a, b;
  float w;
  int inside;
};

// the sample coordinates of crop_and_resize: origin + k * step for pool > 1,
// fused into one rounding as XLA compiles the reference (an explicit fma:
// --fmad=false only stops the compiler from contracting on its own); the
// box centre for pool == 1 (origin holds it, step is unused)
__device__ __forceinline__ Axis sample_axis(float origin, float step, int k,
                                            int pool, float m1, int size) {
  const float s = pool > 1 ? __fmaf_rn((float)k, step, origin) : origin;
  Axis ax;
  ax.inside = s >= 0.0f && s <= m1;
  ax.a = ax.b = 0;
  ax.w = 0.0f;
  if (ax.inside) {
    const float f = floorf(s);
    ax.w = s - f;
    const int i = (int)f;
    ax.a = min(max(i, 0), size - 1);
    ax.b = min(max(i + 1, 0), size - 1);
  }
  return ax;
}

template <typename T>
__global__ void __launch_bounds__(ROI_THREADS)
    roi_align_kernel(Pyramid pyr, const float* __restrict__ boxes, int n,
                     int pool, int C, int slices, int per_slice,
                     float level_scale, float* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  __shared__ Axis ys[MAX_POOL], xs[MAX_POOL];
  __shared__ float s_box[4];
  __shared__ const T* s_feat;
  __shared__ int s_h, s_w;

  // blockIdx.x = (image * n + roi) * slices + slice: image-major
  const int slice = blockIdx.x % slices;
  const int roi = blockIdx.x / slices;  // image * n + roi
  const int img = roi / n;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  if (tid == 0) {
    const float* bx = boxes + (size_t)roi * 4;
    const float y1 = bx[0], x1 = bx[1], y2 = bx[2], x2 = bx[3];
    // roi_level: 4 + round(log2(sqrt(h*w) / (224 / sqrt(image area)))),
    // the division a multiplication by the host's f32 reciprocal
    // (level_scale), as XLA compiles the reference
    const float scale =
        sqrtf(fmaxf((y2 - y1) * (x2 - x1), 1e-12f)) * level_scale;
    float lvl = 4.0f + rintf(log2f(fmaxf(scale, 1e-12f)));
    lvl = fminf(fmaxf(lvl, 2.0f), 5.0f);
    const int li = (int)lvl - 2;
    // selects, not an index into the parameter (which would copy it to
    // local memory)
    const int H = pick(pyr.h, li), W = pick(pyr.w, li);
    s_feat = (const T*)pick(pyr.feat, li) + (size_t)img * H * W * C;
    s_h = H;
    s_w = W;
    const float hm1 = (float)(H - 1), wm1 = (float)(W - 1);
    if (pool > 1) {  // origin and step of the sample grid
      // the step (y2 - y1) * (H - 1) / (pool - 1) as XLA folds it:
      // (y2 - y1) * f32((H - 1) * f32(1 / (pool - 1)))
      const float inv = 1.0f / (float)(pool - 1);
      s_box[0] = y1 * hm1;
      s_box[1] = x1 * wm1;
      s_box[2] = (y2 - y1) * (hm1 * inv);
      s_box[3] = (x2 - x1) * (wm1 * inv);
    } else {          // the centre
      s_box[0] = 0.5f * (y1 + y2) * hm1;
      s_box[1] = 0.5f * (x1 + x2) * wm1;
      s_box[2] = s_box[3] = 0.0f;
    }
  }
  __syncthreads();
  const int H = s_h, W = s_w;
  if (tid < pool)
    ys[tid] = sample_axis(s_box[0], s_box[2], tid, pool, (float)(H - 1), H);
  else if (tid < 2 * pool)
    xs[tid - pool] = sample_axis(s_box[1], s_box[3], tid - pool, pool,
                                 (float)(W - 1), W);
  __syncthreads();

  const T* f = s_feat;
  const int c0 = threadIdx.x * V;
  float* o = out + (size_t)roi * pool * pool * C + c0;
  const int p_end = min(pool * pool, (slice + 1) * per_slice);
  int p = slice * per_slice + threadIdx.y;
  int py = p / pool, px = p - py * pool;
  for (; p < p_end; p += blockDim.y) {
    const Axis ay = ys[py], ax = xs[px];
    float res[V];
    if (ay.inside && ax.inside) {
      float c00[V], c01[V], c10[V], c11[V];
      Vec<T>::load(f + (ay.a * W + ax.a) * C + c0, c00);
      Vec<T>::load(f + (ay.a * W + ax.b) * C + c0, c01);
      Vec<T>::load(f + (ay.b * W + ax.a) * C + c0, c10);
      Vec<T>::load(f + (ay.b * W + ax.b) * C + c0, c11);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float top = c00[k] * (1.0f - ax.w) + c01[k] * ax.w;
        const float bot = c10[k] * (1.0f - ax.w) + c11[k] * ax.w;
        res[k] = top * (1.0f - ay.w) + bot * ay.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) res[k] = 0.0f;
    }
    float4* dst = reinterpret_cast<float4*>(o + (size_t)p * C);
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      dst[k] = make_float4(res[4 * k], res[4 * k + 1], res[4 * k + 2],
                           res[4 * k + 3]);
    px += blockDim.y;
    while (px >= pool) {
      px -= pool;
      ++py;
    }
  }
}

// feats: the four levels [batch, h, w, C] (16-byte aligned), hw: (h, w) of
// each level, boxes f32 [batch, n, 4], out f32 [batch, n, pool, pool, C].
// C % 8 == 0, C / (16 / element size) <= 256 threads, 1 <= pool <= 64, an
// image's level under 2^31 elements; cudaErrorInvalidValue otherwise (the
// wrapper raises first).
extern "C" int roi_align_cuda(int bf16, const void* f0, const void* f1,
                              const void* f2, const void* f3, const int* hw,
                              const float* boxes, int batch, int n, int pool,
                              int C, float level_scale, float* out,
                              void* stream) {
  Pyramid pyr;
  const void* feats[4] = {f0, f1, f2, f3};
  for (int l = 0; l < 4; ++l) {
    pyr.feat[l] = feats[l];
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
  }
  if (batch == 0 || n == 0) return 0;
  const int vec = bf16 ? 8 : 4;
  const int groups = C / vec;  // threads along channels
  if (C < 8 || C % 8 != 0 || groups > ROI_THREADS || pool < 1 ||
      pool > MAX_POOL)
    return (int)cudaErrorInvalidValue;
  const int rows = ROI_THREADS / groups;  // sample points a round
  const int points = pool * pool;
  // split a roi's points over several blocks only when the rois alone
  // would leave SMs idle (the pool-14 head: 32 rois an image)
  const long long rois = (long long)batch * n;
  int slices = 1;
  if (rois < MIN_BLOCKS) {
    const int want = (int)((MIN_BLOCKS + rois - 1) / rois);
    const int most = (points + rows - 1) / rows;  // one round a slice
    slices = want < most ? want : most;
  }
  // whole rounds of `rows` points a slice
  const int rounds = ((points + slices - 1) / slices + rows - 1) / rows;
  const int per_slice = rounds * rows;
  slices = (points + per_slice - 1) / per_slice;
  const long long blocks = rois * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 threads(groups, rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    roi_align_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        pyr, boxes, n, pool, C, slices, per_slice, level_scale, out);
  else
    roi_align_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        pyr, boxes, n, pool, C, slices, per_slice, level_scale, out);
  return (int)cudaGetLastError();
}
