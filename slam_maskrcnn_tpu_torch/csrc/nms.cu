// Greedy non-maximum suppression, fixed-size output, one thread block per
// image, the boxes held in registers.
//
// Replaces the TPU kernel `_nms_kernel` (slam_maskrcnn_tpu/ops/pallas/
// nms_kernel.py, reached through non_max_suppression_pallas(variant=
// "argmax")). Same contract as ops/nms.non_max_suppression: selection k
// takes the live box of highest score (ties to the lower index, as
// jnp.argmax), kills every live box with IoU > threshold against it, and
// writes (index, valid) at slot k; slots after the live set empties are
// (0, false). Unsorted scores in, selection order out, one launch for the
// whole batch.
//
// Bound on an H100: neither bytes (16-20 B per box, read once) nor the
// count of operations, but a chain of up to max_output dependent
// selections, each of which needs every live box's IoU with the last
// winner and a block-wide argmax. What a selection costs is therefore the
// figure of merit, and the design removes from it everything but the
// arithmetic:
// - Each of the 1024 threads keeps its boxes j = tid, tid + 1024, ...
//   (1 to 8 of them: the kernel is a template on that count, so n <= 8192),
//   their areas and an order-preserving integer image of their scores in
//   registers, with a live bit per box (up to 6 boxes fit the 64 registers
//   a thread of such a block may have; 7 and 8 spill a few bytes). Inside the selection loop there is
//   no global memory traffic and no shared memory traffic other than the
//   reduction's 32 entries and the winner's box, which is one float4 read
//   from a copy of all boxes in dynamic shared memory (16 B a box: 96 KB at
//   n = 6000).
// - One block-wide barrier a selection. Every warp reduces its threads'
//   best (score, index) with redux instructions (max over the score image,
//   then min over the indices that hold it: ties to the lower index),
//   lane 0 writes it to red[k & 1][warp], __syncthreads(), then every warp
//   reduces the 32 entries itself, so every thread knows the winner with no
//   second barrier and no broadcast. The two buffers alternate: a warp
//   writes round k + 2 only after barrier k + 1, which every warp passes
//   only after it has read round k.
// - A division only on the edge. IoU > t is decided by comparing the
//   intersection with t * union widened by 8 ulp either way; only a pair
//   inside that band takes inter / max(union, 1e-10), so every decision
//   equals the plain version's. Nearly every pair leaves at the first
//   compare (inter < t_lo * union): a box is suppressed at most once.
// - A slot of 32 boxes whose lanes are all dead costs its warp one
//   predicated branch.
// A selection over 6000 live boxes is then bound by the one SM's
// instruction rate (about 30 per live box, 4 warp instructions a cycle), plus
// the latency of the reduction (two redux pairs, the barrier, two shared
// reads). 1024 threads an image is the measured optimum: with 512 or 256
// threads and 12 or 24 boxes a thread the chain inside a thread is no
// longer hidden. A thread block cluster per image (the boxes split over 2-8
// SMs, the warps' winners written to every block's shared memory, one
// cluster barrier a selection) was built and measured and is not used: the
// cluster barrier alone costs more than this kernel's whole selection.

#include <cstdint>
#include <cuda_runtime.h>

#include "iou.cuh"

#define NMS_THREADS 1024
#define NMS_WARPS (NMS_THREADS / 32)
#define NMS_MAX_N 8192
#define NMS_MAX_BPT (NMS_MAX_N / NMS_THREADS)   // boxes a thread, at most
#define FULL_MASK 0xffffffffu
#define NO_INDEX 0x7fffffffu
// scores at or below this never select (ops/nms.py: NEG_INF / 2)
#define DEAD_SCORE (-5.0e8f)

// Unsigned image of a float that keeps its order; -0 and +0 map to one key
// (they compare equal). 0 is kept for dead boxes: no score above DEAD_SCORE
// maps to it.
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned b = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int BPT>
__global__ void __launch_bounds__(NMS_THREADS)
    nms_kernel(const float4* __restrict__ boxes,
               const float* __restrict__ scores, int n, int max_output,
               float iou_threshold, float score_threshold,
               int32_t* __restrict__ idx_out, uint8_t* __restrict__ valid_out) {
  extern __shared__ float4 sbox[];             // [n]
  __shared__ uint2 red[2][NMS_WARPS];          // (score key, index) per warp

  const int b = blockIdx.x;
  const float4* bx = boxes + (long long)b * n;
  const float* sc = scores + (long long)b * n;
  int32_t* io = idx_out + (long long)b * max_output;
  uint8_t* vo = valid_out + (long long)b * max_output;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const IouBand band = iou_band(iou_threshold);

  float4 box[BPT];
  float area[BPT];
  unsigned key[BPT];
  unsigned live = 0;
#pragma unroll
  for (int s = 0; s < BPT; ++s) {
    const int j = tid + s * NMS_THREADS;
    box[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    key[s] = 0;
    if (j < n) {
      box[s] = bx[j];
      sbox[j] = box[s];
      const float v = sc[j];
      if (v > score_threshold && v > DEAD_SCORE) {
        key[s] = score_key(v);
        live |= 1u << s;
      }
    }
    area[s] = (box[s].z - box[s].x) * (box[s].w - box[s].y);
  }
  for (int k = tid; k < max_output; k += NMS_THREADS) {
    io[k] = 0;
    vo[k] = 0;
  }

  // this thread's best live box; slots are in index order, so a strict
  // compare keeps the lower index on ties
  unsigned best_k = 0, best_i = NO_INDEX;
#pragma unroll
  for (int s = 0; s < BPT; ++s)
    if (((live >> s) & 1u) && key[s] > best_k) {
      best_k = key[s];
      best_i = tid + s * NMS_THREADS;
    }

  for (int k = 0; k < max_output; ++k) {
    // block-wide argmax over (score, lower index on ties), one barrier
    const unsigned wk = __reduce_max_sync(FULL_MASK, best_k);
    const unsigned wi =
        __reduce_min_sync(FULL_MASK, best_k == wk ? best_i : NO_INDEX);
    if (lane == 0) red[k & 1][warp] = make_uint2(wk, wi);
    __syncthreads();
    const uint2 e = lane < NMS_WARPS ? red[k & 1][lane]
                                     : make_uint2(0u, NO_INDEX);
    const unsigned gk = __reduce_max_sync(FULL_MASK, e.x);
    const unsigned sel =
        __reduce_min_sync(FULL_MASK, e.x == gk ? e.y : NO_INDEX);
    if (gk == 0) break;  // nothing live: the remaining slots stay (0, false)
    if (tid == 0) {
      io[k] = (int32_t)sel;
      vo[k] = 1;
    }
    if (k + 1 == max_output) break;

    const float4 w = sbox[sel];
    const float warea = (w.z - w.x) * (w.w - w.y);
    if (tid == (int)(sel % NMS_THREADS)) live &= ~(1u << (sel / NMS_THREADS));
    // suppress against the winner and find this thread's next best
    best_k = 0;
    best_i = NO_INDEX;
#pragma unroll
    for (int s = 0; s < BPT; ++s) {
      if ((live >> s) & 1u) {
        const float inter = box_inter(w, box[s]);
        if (iou_above(inter, warea + area[s] - inter, band)) {
          live &= ~(1u << s);
        } else if (key[s] > best_k) {
          best_k = key[s];
          best_i = tid + s * NMS_THREADS;
        }
      }
    }
  }
}

template <int BPT>
static int launch(const float* boxes, const float* scores, int batch, int n,
                  int max_output, float iou_threshold, float score_threshold,
                  int32_t* idx_out, uint8_t* valid_out, cudaStream_t stream) {
  const size_t smem = (size_t)n * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_kernel<BPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<BPT><<<batch, NMS_THREADS, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, n, max_output,
      iou_threshold, score_threshold, idx_out, valid_out);
  return (int)cudaGetLastError();
}

// The instantiation for `bpt` boxes a thread.
template <int BPT>
static int launch_for(int bpt, const float* boxes, const float* scores,
                      int batch, int n, int max_output, float iou_threshold,
                      float score_threshold, int32_t* idx_out,
                      uint8_t* valid_out, cudaStream_t stream) {
  if (bpt == BPT)
    return launch<BPT>(boxes, scores, batch, n, max_output, iou_threshold,
                       score_threshold, idx_out, valid_out, stream);
  if constexpr (BPT < NMS_MAX_BPT)
    return launch_for<BPT + 1>(bpt, boxes, scores, batch, n, max_output,
                               iou_threshold, score_threshold, idx_out,
                               valid_out, stream);
  else
    return (int)cudaErrorInvalidValue;
}

// boxes f32 [batch, n, 4] (16-byte aligned), scores f32 [batch, n],
// n <= 8192 (cudaErrorInvalidValue above that; the wrapper raises first).
extern "C" int nms_cuda(const float* boxes, const float* scores, int batch,
                        int n, int max_output, float iou_threshold,
                        float score_threshold, int32_t* idx_out,
                        uint8_t* valid_out, void* stream) {
  const int bpt = (n + NMS_THREADS - 1) / NMS_THREADS;
  return launch_for<1>(bpt < 1 ? 1 : bpt, boxes, scores, batch, n, max_output,
                       iou_threshold, score_threshold, idx_out, valid_out,
                       (cudaStream_t)stream);
}
