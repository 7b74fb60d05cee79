// The RPN's anchor labels of one training image: matterport's
// build_rpn_targets (Mask_RCNN/mrcnn/model.py:1450-1504) before its random
// subsample, the matching of every anchor to the image's gt boxes.
//
// Replaces no TPU kernel: the JAX package builds these targets on the host
// in numpy (slam_maskrcnn_tpu/models/targets.py `build_rpn_targets`), and
// the port did the same in its data generator. At the COCO training shape
// (1024^2, 261,888 anchors) the [A, G] IoU matrix, its maxima and the
// column ties cost the host about 90-120 ms an image, a third of the batch
// that the card waits for. Here the matching is two launches an image; the
// host keeps the subsample (numpy's global stream) and the deltas.
//
// In: anchors f32 [A, 4] (y1, x1, y2, x2, pixels), boxes f32 [G + C, 4]:
// the G gt boxes that match, then the C crowd boxes. Out: out i32 [2, A],
// row 0 the label (-1, 0, 1) before the subsample, row 1 the index of the
// anchor's best gt (the first on ties, as np.argmax); scratch colmax i32
// [G], zeroed by the entry point. Per anchor a:
//   iou(a, g)   = inter / max(area_a + area_g - inter, 1e-10), in the order
//                 of targets.py `_overlaps_np` (csrc/iou.cuh `box_inter`,
//                 `box_area`; built with --fmad=false, IEEE division);
//   best, arg   = the max over g < G and its first index;
//   no_crowd    = C == 0 or the max over the crowd boxes < 0.001f;
//   label       = 1 if best >= 0.7f or iou(a, g) equals the column max of
//                 some g over all anchors (every tie, and a gt that
//                 overlaps no anchor makes every zero-IoU anchor positive,
//                 model.py:1499-1502), else -1 if best < 0.3f and no_crowd,
//                 else 0.
// The boxes are finite (pixel boxes), so every IoU is >= 0 (or -0) and its
// bits order as signed ints: the column max is an atomicMax on the bits
// (-0 sorts below +0, and compares equal to it as a float, as in numpy).
//
// Pass 1 (a thread an anchor): best, arg, no_crowd, the labels that need
// no column max, and the column maxima: a warp's max by __reduce_max_sync,
// a block's in shared memory, then one atomicMax a gt a block. Pass 2
// recomputes the same IoUs (the same bits) and marks the ties. Both stage
// the boxes through shared memory TILE at a time, so any G + C works.
//
// Bound: launch latency. The work at 261,888 anchors and 12 gt is 3.1M
// IoUs a pass (about 40 MFLOP) over 4.2 MB of anchors read and 2.1 MB
// written: a few microseconds of the card's bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

#include "iou.cuh"

#define RPN_THREADS 256
#define TILE RPN_THREADS  // boxes staged a tile, one a thread

__device__ __forceinline__ float rpn_iou(float4 a, float area_a, float4 g,
                                         float area_g) {
  const float inter = box_inter(a, g);
  return inter / fmaxf(area_a + area_g - inter, 1e-10f);
}

__global__ void __launch_bounds__(RPN_THREADS)
    rpn_match_kernel(const float4* __restrict__ anchors, int A,
                     const float4* __restrict__ boxes, int G, int C,
                     int32_t* __restrict__ out, int* __restrict__ colmax) {
  __shared__ float4 sbox[TILE];
  __shared__ float sarea[TILE];
  __shared__ int smax[TILE];
  const int a = blockIdx.x * RPN_THREADS + threadIdx.x;
  const bool valid = a < A;
  const float4 an = anchors[valid ? a : 0];
  const float area = box_area(an);
  float best = 0.f, crowd = -INFINITY;
  int arg = 0;
  for (int t0 = 0; t0 < G + C; t0 += TILE) {
    const int n = min(TILE, G + C - t0);
    __syncthreads();  // the previous tile's reads are done
    if (threadIdx.x < n) {
      const float4 b = boxes[t0 + threadIdx.x];
      sbox[threadIdx.x] = b;
      sarea[threadIdx.x] = box_area(b);
      smax[threadIdx.x] = 0;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int g = t0 + j;
      const float v = rpn_iou(an, area, sbox[j], sarea[j]);
      if (g < G) {  // uniform over the block
        if (g == 0 || v > best) {
          best = v;
          arg = g;
        }
        const int m = __reduce_max_sync(0xffffffffu,
                                        valid ? __float_as_int(v) : 0);
        if ((threadIdx.x & 31) == 0) atomicMax(&smax[j], m);
      } else {
        crowd = fmaxf(crowd, v);
      }
    }
    __syncthreads();
    if (threadIdx.x < n && t0 + (int)threadIdx.x < G)
      atomicMax(&colmax[t0 + threadIdx.x], smax[threadIdx.x]);
  }
  if (!valid) return;
  const bool no_crowd = crowd < 0.001f;  // C == 0: -inf
  out[a] = best >= 0.7f ? 1 : (best < 0.3f && no_crowd ? -1 : 0);
  out[A + a] = arg;
}

__global__ void __launch_bounds__(RPN_THREADS)
    rpn_ties_kernel(const float4* __restrict__ anchors, int A,
                    const float4* __restrict__ boxes, int G,
                    const int* __restrict__ colmax,
                    int32_t* __restrict__ out) {
  __shared__ float4 sbox[TILE];
  __shared__ float sarea[TILE];
  __shared__ float scol[TILE];
  const int a = blockIdx.x * RPN_THREADS + threadIdx.x;
  const bool valid = a < A;
  const float4 an = anchors[valid ? a : 0];
  const float area = box_area(an);
  bool tie = !valid || out[a] == 1;  // nothing left to find
  for (int t0 = 0; t0 < G; t0 += TILE) {
    const int n = min(TILE, G - t0);
    __syncthreads();
    if (threadIdx.x < n) {
      const float4 b = boxes[t0 + threadIdx.x];
      sbox[threadIdx.x] = b;
      sarea[threadIdx.x] = box_area(b);
      scol[threadIdx.x] = __int_as_float(colmax[t0 + threadIdx.x]);
    }
    __syncthreads();
    for (int j = 0; j < n && !tie; ++j)
      tie = rpn_iou(an, area, sbox[j], sarea[j]) == scol[j];
  }
  if (valid && tie) out[a] = 1;
}

// anchors f32 [A, 4], boxes f32 [G + C, 4] (G >= 1 gt, then C crowd), out
// i32 [2, A], colmax i32 [G] scratch; on `stream`, nothing synchronised.
extern "C" int rpn_match_cuda(const float* anchors, int A, const float* boxes,
                              int G, int C, int32_t* out, int* colmax,
                              void* stream) {
  if (A < 1 || G < 1 || C < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(colmax, 0, sizeof(int) * G, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (A + RPN_THREADS - 1) / RPN_THREADS;
  const float4* an = reinterpret_cast<const float4*>(anchors);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  rpn_match_kernel<<<blocks, RPN_THREADS, 0, s>>>(an, A, bx, G, C, out,
                                                  colmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rpn_ties_kernel<<<blocks, RPN_THREADS, 0, s>>>(an, A, bx, G, colmax, out);
  return (int)cudaGetLastError();
}
