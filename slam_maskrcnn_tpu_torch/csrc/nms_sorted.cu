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
// the work splits into a parallel and a serial part:
//   (a) `pair_mask_kernel`: a grid of 64-thread blocks fills the bit matrix
//       M[i][w] (n rows of ceil(n/64) 64-bit words), bit j of row i set iff
//       j > i and IoU(i, j) > threshold. All n^2/2 IoUs run in parallel.
//   (b) `scan_kernel`: one block per image walks the boxes 64 at a time.
//       One thread resolves a 64-box chunk against the chunk's diagonal
//       words (64 dependent steps on shared memory); then all threads OR
//       the rows of the chunk's kept boxes into the removed-set of the later
//       chunks, the loads of different rows being independent.
//
// Bound on an H100: operations, by count n^2/2 IoUs of ~12 flops (the
// inputs are 16 B per box, the output 1 B); what the kernel actually waits
// for is the serial walk of (b), n/64 chunks of 64 dependent steps.

#include <cstdint>
#include <cuda_runtime.h>

#define CHUNK 64
#define SCAN_THREADS 256

__global__ void pair_mask_kernel(const float* __restrict__ boxes, int n,
                                 int nw, float iou_threshold,
                                 unsigned long long* __restrict__ bits) {
  const int col = blockIdx.x, row = blockIdx.y, b = blockIdx.z;
  const float* bx = boxes + (long long)b * n * 4;
  unsigned long long* out = bits + (long long)b * n * nw;
  const int t = threadIdx.x;
  const int i = row * CHUNK + t;
  if (col < row) {  // every j of this column block is < i
    if (i < n) out[(long long)i * nw + col] = 0ull;
    return;
  }
  __shared__ float cb[CHUNK][4];
  __shared__ float carea[CHUNK];
  const int j0 = col * CHUNK;
  if (j0 + t < n) {
    const float y1 = bx[(j0 + t) * 4 + 0], x1 = bx[(j0 + t) * 4 + 1];
    const float y2 = bx[(j0 + t) * 4 + 2], x2 = bx[(j0 + t) * 4 + 3];
    cb[t][0] = y1;
    cb[t][1] = x1;
    cb[t][2] = y2;
    cb[t][3] = x2;
    carea[t] = (y2 - y1) * (x2 - x1);
  }
  __syncthreads();
  if (i >= n) return;
  const float y1 = bx[i * 4 + 0], x1 = bx[i * 4 + 1];
  const float y2 = bx[i * 4 + 2], x2 = bx[i * 4 + 3];
  const float area = (y2 - y1) * (x2 - x1);
  unsigned long long word = 0ull;
  const int jn = min(CHUNK, n - j0);
  for (int jj = 0; jj < jn; ++jj) {
    if (j0 + jj <= i) continue;
    const float iy = fmaxf(fminf(cb[jj][2], y2) - fmaxf(cb[jj][0], y1), 0.f);
    const float ix = fmaxf(fminf(cb[jj][3], x2) - fmaxf(cb[jj][1], x1), 0.f);
    const float inter = iy * ix;
    const float iou = inter / fmaxf(carea[jj] + area - inter, 1e-10f);
    if (iou > iou_threshold) word |= 1ull << jj;
  }
  out[(long long)i * nw + col] = word;
}

__global__ void scan_kernel(const unsigned long long* __restrict__ bits,
                            int n, int nw, uint8_t* __restrict__ sup) {
  extern __shared__ unsigned long long removed[];  // [nw]
  __shared__ unsigned long long diag[CHUNK];
  __shared__ unsigned long long kept_word;
  const int b = blockIdx.x;
  const unsigned long long* M = bits + (long long)b * n * nw;
  uint8_t* so = sup + (long long)b * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = SCAN_THREADS / 32;

  for (int w = tid; w < nw; w += SCAN_THREADS) removed[w] = 0ull;
  __syncthreads();

  for (int wb = 0; wb < nw; ++wb) {
    const int i0 = wb * CHUNK;
    const int cn = min(CHUNK, n - i0);
    if (tid < CHUNK)
      diag[tid] = tid < cn ? M[(long long)(i0 + tid) * nw + wb] : 0ull;
    __syncthreads();
    if (tid == 0) {
      // the boxes of this chunk in order: a box not yet removed is kept
      // and removes the later boxes of the chunk that it overlaps
      unsigned long long cur = removed[wb], kept = 0ull;
      for (int t = 0; t < cn; ++t) {
        if (!((cur >> t) & 1ull)) {
          kept |= 1ull << t;
          cur |= diag[t];
        }
      }
      removed[wb] = cur;
      kept_word = kept;
    }
    __syncthreads();
    const unsigned long long cur = removed[wb];
    if (tid < cn) so[i0 + tid] = (uint8_t)((cur >> tid) & 1ull);
    // kept rows of this chunk remove boxes of the later chunks: warp k
    // takes the kept rows t = k, k + n_warps, ...; lanes take the words
    const unsigned long long kept = kept_word;
    for (int w = wb + 1 + lane; w < nw; w += 32) {
      unsigned long long acc = 0ull;
      for (int t = warp; t < cn; t += n_warps)
        if ((kept >> t) & 1ull) acc |= M[(long long)(i0 + t) * nw + w];
      if (acc) atomicOr(&removed[w], acc);
    }
    __syncthreads();
  }
}

extern "C" int nms_sorted_cuda(const float* boxes, int batch, int n,
                               float iou_threshold, void* bits, uint8_t* sup,
                               void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int nw = (n + CHUNK - 1) / CHUNK;
  cudaStream_t s = (cudaStream_t)stream;
  pair_mask_kernel<<<dim3(nw, nw, batch), CHUNK, 0, s>>>(
      boxes, n, nw, iou_threshold, (unsigned long long*)bits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<batch, SCAN_THREADS, (size_t)nw * sizeof(unsigned long long),
                s>>>((const unsigned long long*)bits, n, nw, sup);
  return (int)cudaGetLastError();
}
