// Suppression mask of greedy NMS over boxes already sorted by descending
// score.
//
// Replaces the TPU kernel `_nms_sorted_kernel` (slam_maskrcnn_tpu/ops/
// pallas/nms_kernel.py, reached through non_max_suppression_pallas(
// variant="sorted")). Same contract: boxes [n, 4] (y1, x1, y2, x2) in
// selection order in, sup [n] out, sup[j] = 1 iff box j is killed by an
// earlier kept box i < j, i.e. IoU(i, j) > threshold with
//   IoU = inter / max(area_i + area_j - inter, 1e-10).
// The sort, the score threshold and the cut to max_output stay outside, in
// ops/nms.py, as they stay outside the TPU kernel.
//
// The TPU kernel walks 128-lane tiles and suppresses later boxes with dense
// [128, n] IoU blocks, because its state must fit one vector register. Here
// the work splits into a parallel and a serial part, one kernel each:
//   (a) `pair_mask_kernel` fills the bit matrix M[i][w] (n rows of
//       nw = ceil(n / 64) 64-bit words): bit jj of M[i][w] is set iff
//       j = 64 w + jj > i and IoU(i, j) > threshold. Only the words the
//       scan reads are computed, those of column chunks w >= chunk(i): the
//       grid is the upper triangle, a linear block index mapped to (row
//       group, column chunk). A block of 256 threads takes four row chunks
//       (a row a thread, its box in registers) against one column chunk of
//       64 boxes in shared memory. IoU > t is decided without the division
//       except within 8 ulp of t (iou.cuh, shared with csrc/nms.cu), and
//       without a branch in the loop: the pairs in the band are marked and
//       divided after it.
//   (b) `scan_kernel`, one block of 1024 threads per image, walks the 64-box
//       chunks in order with one barrier a chunk. Warp 0 resolves chunk wb
//       in registers: lane l holds the diagonal words of boxes l and l + 32
//       (prefetched during the previous chunk); a ballot marks the boxes
//       that suppress anything later in the chunk, and the walk visits only
//       those that survive (lowest first, their word fetched by shuffle),
//       so its length is the number of kept suppressors, not 64. Warp 0
//       then ORs the kept rows' words of chunk wb + 1 (also prefetched) with
//       one reduction: that word is all the next chunk waits for. Warps
//       1-31 meanwhile OR the previous chunk's kept rows into the removed
//       words of the chunks after the next, their loads independent of one
//       another, so a chunk costs one load depth plus a reduction.
//
// Bound on an H100: operations, by count n (n - 1) / 2 IoUs of ~12 flops
// (the inputs are 16 B a box, the output 1 B); what (b) waits for is the
// chain of n / 64 chunks. The scan is one block on one SM, so the
// instructions all its warps issue per chunk count, not only one warp's
// latency: scans that took every load off the chain (cp.async rings,
// register sets two chunks deep, the kept rows' words staged in shared
// memory) issued more and were slower on the main path's proposals, where
// nearly every box is kept.

#include <cstdint>
#include <cuda_runtime.h>

#include "iou.cuh"

#define CHUNK 64
#define PAIR_ROWS 256                   // rows (4 row chunks) a pair block
#define PAIR_GROUP (PAIR_ROWS / CHUNK)
#define SCAN_THREADS 1024
#define SCAN_WARPS (SCAN_THREADS / 32)
#define FULL_MASK 0xffffffffu

typedef unsigned long long u64;

// blocks of row group g: the column chunks 4 g .. nw - 1
__device__ __forceinline__ long long blocks_before(long long g, int nw) {
  return g * nw - 2 * g * (g - 1);  // sum over k < g of (nw - 4 k)
}

__global__ void __launch_bounds__(PAIR_ROWS)
    pair_mask_kernel(const float4* __restrict__ boxes, int n, int nw,
                     float iou_threshold, u64* __restrict__ bits) {
  __shared__ float4 cb[CHUNK];
  __shared__ float carea[CHUNK];
  const int b = blockIdx.y;
  const int ng = (nw + PAIR_GROUP - 1) / PAIR_GROUP;
  // the linear block index -> (row group g, column chunk col >= 4 g)
  const long long lin = blockIdx.x;
  const double q = (double)nw + 2.0;
  long long g = (long long)((q - sqrt(fmax(q * q - 8.0 * (double)lin, 0.0)))
                            / 4.0);
  g = g < 0 ? 0 : (g >= ng ? ng - 1 : g);
  while (g > 0 && blocks_before(g, nw) > lin) --g;
  while (g + 1 < ng && blocks_before(g + 1, nw) <= lin) ++g;
  const int col = PAIR_GROUP * (int)g + (int)(lin - blocks_before(g, nw));

  const float4* bx = boxes + (size_t)b * n;
  u64* out = bits + (size_t)b * n * nw;
  const int t = threadIdx.x;
  const int j0 = col * CHUNK;
  const int jn = min(CHUNK, n - j0);
  if (t < CHUNK) {
    const float4 c = t < jn ? bx[j0 + t] : make_float4(0.f, 0.f, 0.f, 0.f);
    cb[t] = c;
    carea[t] = box_area(c);
  }
  __syncthreads();
  const int i = (int)g * PAIR_ROWS + t;
  const int rc = i / CHUNK;  // this row's chunk
  if (i >= n || col < rc) return;  // a word the scan never reads
  const float4 r = bx[i];
  const float area = box_area(r);
  const IouBand band = iou_band(iou_threshold);
  // no branch in the loop: the sure answers set bits of `word`, pairs in
  // the band set bits of `band_bits`, decided by the division afterwards
  u64 word = 0ull, band_bits = 0ull;
#pragma unroll 16
  for (int jj = 0; jj < CHUNK; ++jj) {
    const float inter = box_inter(cb[jj], r);
    const float u = iou_denominator(carea[jj] + area - inter);
    const bool above = iou_surely_above(inter, u, band);
    word |= (u64)above << jj;
    band_bits |= (u64)(!above && !iou_surely_below(inter, u, band)) << jj;
  }
  while (band_bits) {  // rare: pairs within 8 ulp of the threshold
    const int jj = __ffsll((long long)band_bits) - 1;
    band_bits &= band_bits - 1ull;
    const float inter = box_inter(cb[jj], r);
    const float u = iou_denominator(carea[jj] + area - inter);
    if (iou_divided_above(inter, u, band)) word |= 1ull << jj;
  }
  // only j > i, only j < n
  if (col == rc) {
    const int k = i - j0;  // 0..63
    word &= k == CHUNK - 1 ? 0ull : ~0ull << (k + 1);
  }
  if (jn < CHUNK) word &= (1ull << jn) - 1ull;
  out[(size_t)i * nw + col] = word;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(const u64* __restrict__ bits, int n, int nw,
                uint8_t* __restrict__ sup) {
  extern __shared__ u64 removed[];  // [nw]
  __shared__ u64 kept_sh[2];
  const int b = blockIdx.x;
  const u64* M = bits + (size_t)b * n * nw;
  uint8_t* so = sup + (size_t)b * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int w = tid; w < nw; w += SCAN_THREADS) removed[w] = 0ull;

  // warp 0: the diagonal words (d) and the next column's words (x) of the
  // rows lane and lane + 32 of a chunk; 0 past n or past the last chunk
  auto fetch = [&](int wb, int row, int col) -> u64 {
    const int i = wb * CHUNK + row;
    return (wb < nw && col < nw && i < n) ? M[(size_t)i * nw + col] : 0ull;
  };
  u64 d_lo = 0, d_hi = 0, x_lo = 0, x_hi = 0, carry = 0;
  if (warp == 0) {
    d_lo = fetch(0, lane, 0);
    d_hi = fetch(0, lane + 32, 0);
    x_lo = fetch(0, lane, 1);
    x_hi = fetch(0, lane + 32, 1);
  }
  __syncthreads();

  for (int wb = 0; wb < nw; ++wb) {
    if (warp == 0) {
      // the next chunk's words, in flight while this one resolves
      const u64 nd_lo = fetch(wb + 1, lane, wb + 1);
      const u64 nd_hi = fetch(wb + 1, lane + 32, wb + 1);
      const u64 nx_lo = fetch(wb + 1, lane, wb + 2);
      const u64 nx_hi = fetch(wb + 1, lane + 32, wb + 2);

      const int i0 = wb * CHUNK;
      const int cn = min(CHUNK, n - i0);
      const u64 valid = cn == CHUNK ? ~0ull : (1ull << cn) - 1ull;
      // removed[wb] holds every earlier chunk's kills but the last one's,
      // which is carry
      u64 cur = removed[wb] | carry;
      // boxes that suppress something later in the chunk
      const u64 supp = (u64)__ballot_sync(FULL_MASK, d_lo != 0ull)
                       | ((u64)__ballot_sync(FULL_MASK, d_hi != 0ull) << 32);
      // in order, each surviving suppressor kills its later boxes; a box
      // that suppresses nothing in the chunk changes nothing here
      u64 todo = ~cur & valid & supp;
      while (todo) {
        const int t = __ffsll((long long)todo) - 1;
        const u64 lo = __shfl_sync(FULL_MASK, d_lo, t & 31);
        const u64 hi = __shfl_sync(FULL_MASK, d_hi, t & 31);
        cur |= t < 32 ? lo : hi;
        todo = ~cur & valid & supp & (t == CHUNK - 1 ? 0ull
                                                     : ~0ull << (t + 1));
      }
      if (lane < cn) so[i0 + lane] = (uint8_t)((cur >> lane) & 1ull);
      if (lane + 32 < cn)
        so[i0 + lane + 32] = (uint8_t)((cur >> (lane + 32)) & 1ull);
      const u64 kept = ~cur & valid;
      if (lane == 0) kept_sh[wb & 1] = kept;
      // the kept rows' words of chunk wb + 1: what the next chunk waits for
      const u64 v = (((kept >> lane) & 1ull) ? x_lo : 0ull)
                    | (((kept >> (lane + 32)) & 1ull) ? x_hi : 0ull);
      carry = (u64)__reduce_or_sync(FULL_MASK, (unsigned)v)
              | ((u64)__reduce_or_sync(FULL_MASK, (unsigned)(v >> 32)) << 32);
      d_lo = nd_lo;
      d_hi = nd_hi;
      x_lo = nx_lo;
      x_hi = nx_hi;
    } else if (wb >= 1) {
      // the previous chunk's kept rows (warp k takes rows k - 1, k + 30,
      // k + 61) into the removed words of chunks wb + 1 on (lanes)
      const u64 kept = kept_sh[(wb - 1) & 1];
      const int t0 = warp - 1, t1 = t0 + SCAN_WARPS - 1,
                t2 = t0 + 2 * (SCAN_WARPS - 1);
      const bool k0 = (kept >> t0) & 1ull, k1 = (kept >> t1) & 1ull;
      const bool k2 = t2 < CHUNK && ((kept >> (t2 & 63)) & 1ull);
      const u64* m0 = M + (size_t)((wb - 1) * CHUNK + t0) * nw;
      const u64* m1 = m0 + (size_t)(SCAN_WARPS - 1) * nw;
      const u64* m2 = m1 + (size_t)(SCAN_WARPS - 1) * nw;
      if (k0 || k1 || k2) {
        for (int w = wb + 1 + lane; w < nw; w += 32) {
          const u64 acc = (k0 ? m0[w] : 0ull) | (k1 ? m1[w] : 0ull)
                          | (k2 ? m2[w] : 0ull);
          if (acc) atomicOr(&removed[w], acc);
        }
      }
    }
    __syncthreads();
  }
}

static int pairs(const float* boxes, int batch, int n, float iou_threshold,
                 void* bits, cudaStream_t s) {
  const int nw = (n + CHUNK - 1) / CHUNK;
  const long long ng = (nw + PAIR_GROUP - 1) / PAIR_GROUP;
  const long long blocks = ng * nw - 2 * ng * (ng - 1);
  if (blocks > 0x7fffffffLL || batch > 65535)
    return (int)cudaErrorInvalidValue;
  pair_mask_kernel<<<dim3((unsigned)blocks, batch), PAIR_ROWS, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), n, nw, iou_threshold,
      (u64*)bits);
  return (int)cudaGetLastError();
}

static int scan(int batch, int n, const void* bits, uint8_t* sup,
                cudaStream_t s) {
  const int nw = (n + CHUNK - 1) / CHUNK;
  const size_t smem = (size_t)nw * sizeof(u64);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<<<batch, SCAN_THREADS, smem, s>>>((const u64*)bits, n, nw,
                                                 sup);
  return (int)cudaGetLastError();
}

// boxes f32 [batch, n, 4] (16-byte aligned) sorted by descending score,
// bits scratch [batch, n, ceil(n / 64)] u64 (only the upper triangle is
// written), sup u8 [batch, n] out.
extern "C" int nms_sorted_cuda(const float* boxes, int batch, int n,
                               float iou_threshold, void* bits, uint8_t* sup,
                               void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int e = pairs(boxes, batch, n, iou_threshold, bits,
                      (cudaStream_t)stream);
  if (e != 0) return e;
  return scan(batch, n, bits, sup, (cudaStream_t)stream);
}

// the two kernels on their own (samples/kernel_probe.py times them apart)
extern "C" int nms_sorted_pairs_cuda(const float* boxes, int batch, int n,
                                     float iou_threshold, void* bits,
                                     void* stream) {
  if (batch == 0 || n == 0) return 0;
  return pairs(boxes, batch, n, iou_threshold, bits, (cudaStream_t)stream);
}

extern "C" int nms_sorted_scan_cuda(int batch, int n, const void* bits,
                                    uint8_t* sup, void* stream) {
  if (batch == 0 || n == 0) return 0;
  return scan(batch, n, bits, sup, (cudaStream_t)stream);
}
