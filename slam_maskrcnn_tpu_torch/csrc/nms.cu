// Greedy non-maximum suppression, fixed-size output, one thread block per
// image.
//
// Replaces the TPU kernel `_nms_kernel` (slam_maskrcnn_tpu/ops/pallas/
// nms_kernel.py, reached through non_max_suppression_pallas(variant=
// "argmax")). Same contract as ops/nms.non_max_suppression: selection k
// takes the live box of highest score (ties to the lower index, as
// jnp.argmax), kills every live box with IoU > threshold against it, and
// writes (index, valid) at slot k; slots after the live set empties are
// (0, false).
//
// Each of the block's threads owns the boxes j = tid, tid + blockDim, ...
// The live scores sit in shared memory. One pass per selection both
// applies the previous selection's suppression and finds each thread's
// best survivor; a block-wide argmax over (score, index) then names the
// next selection. The loop stops as soon as nothing is live.
//
// Bound on an H100: latency, not bytes or operations. The inputs are
// read once (16-20 B per box), but each selection costs two block-wide
// barriers, so time grows with the number of selections (up to 1000 on the
// proposal path). A parallel bitmask NMS is the known faster form.

#include <cstdint>
#include <cuda_runtime.h>

#define NMS_THREADS 1024
#define NEG_SCORE (-1.0e9f)

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__global__ void nms_kernel(const float* __restrict__ boxes,
                           const float* __restrict__ scores, int n,
                           int max_output, float iou_threshold,
                           float score_threshold, int32_t* __restrict__ idx_out,
                           uint8_t* __restrict__ valid_out) {
  extern __shared__ float live[];  // [n]
  __shared__ float red_s[NMS_THREADS / 32];
  __shared__ int red_i[NMS_THREADS / 32];
  __shared__ int sel_shared;

  const int b = blockIdx.x;
  const float* bx = boxes + (long long)b * n * 4;
  const float* sc = scores + (long long)b * n;
  int32_t* io = idx_out + (long long)b * max_output;
  uint8_t* vo = valid_out + (long long)b * max_output;
  const int tid = threadIdx.x;

  for (int j = tid; j < n; j += blockDim.x) {
    const float s = sc[j];
    live[j] = s > score_threshold ? s : NEG_SCORE;
  }
  for (int k = tid; k < max_output; k += blockDim.x) {
    io[k] = 0;
    vo[k] = 0;
  }
  __syncthreads();

  int sel = -1;
  float sy1 = 0.f, sx1 = 0.f, sy2 = 0.f, sx2 = 0.f, sarea = 0.f;
  for (int k = 0; k < max_output; ++k) {
    // suppress against the previous selection, and find this thread's best
    float best_s = NEG_SCORE;
    int best_i = 0x7fffffff;
    for (int j = tid; j < n; j += blockDim.x) {
      float s = live[j];
      if (sel >= 0 && s > NEG_SCORE * 0.5f) {
        bool kill = (j == sel);
        if (!kill) {
          const float y1 = bx[j * 4 + 0], x1 = bx[j * 4 + 1];
          const float y2 = bx[j * 4 + 2], x2 = bx[j * 4 + 3];
          const float iy1 = fmaxf(sy1, y1), ix1 = fmaxf(sx1, x1);
          const float iy2 = fminf(sy2, y2), ix2 = fminf(sx2, x2);
          const float inter = fmaxf(iy2 - iy1, 0.f) * fmaxf(ix2 - ix1, 0.f);
          const float area = (y2 - y1) * (x2 - x1);
          const float iou = inter / fmaxf(sarea + area - inter, 1e-10f);
          kill = iou > iou_threshold;
        }
        if (kill) {
          s = NEG_SCORE;
          live[j] = s;
        }
      }
      if (better(s, j, best_s, best_i)) {
        best_s = s;
        best_i = j;
      }
    }
    // block-wide argmax over (score, lower index on ties)
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best_s, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      if (better(os, oi, best_s, best_i)) {
        best_s = os;
        best_i = oi;
      }
    }
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) {
      red_s[warp] = best_s;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      best_s = lane < nw ? red_s[lane] : NEG_SCORE;
      best_i = lane < nw ? red_i[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, best_s, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        if (better(os, oi, best_s, best_i)) {
          best_s = os;
          best_i = oi;
        }
      }
      if (lane == 0) {
        const bool ok = best_s > NEG_SCORE * 0.5f;
        sel_shared = ok ? best_i : -1;
        if (ok) {
          io[k] = best_i;
          vo[k] = 1;
        }
      }
    }
    __syncthreads();
    sel = sel_shared;
    if (sel < 0) break;  // nothing live: the remaining slots stay (0, false)
    sy1 = bx[sel * 4 + 0];
    sx1 = bx[sel * 4 + 1];
    sy2 = bx[sel * 4 + 2];
    sx2 = bx[sel * 4 + 3];
    sarea = (sy2 - sy1) * (sx2 - sx1);
  }
}

extern "C" int nms_cuda(const float* boxes, const float* scores, int batch,
                        int n, int max_output, float iou_threshold,
                        float score_threshold, int32_t* idx_out,
                        uint8_t* valid_out, void* stream) {
  const size_t smem = (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<<<batch, NMS_THREADS, smem, (cudaStream_t)stream>>>(
      boxes, scores, n, max_output, iou_threshold, score_threshold, idx_out,
      valid_out);
  return (int)cudaGetLastError();
}
