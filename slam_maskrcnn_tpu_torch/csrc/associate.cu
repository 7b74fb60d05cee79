// The association's decisions after its f32 score: best global id per
// current id, the greedy 1-1 claim, fresh ids, the relabel table.
//
// Replaces no TPU kernel: the JAX package runs this claim as a
// `lax.fori_loop` inside its jitted step (slam_maskrcnn_tpu/fusion/
// associate.py `associate_instances`), which XLA keeps on the device. The
// port's eager PyTorch runs the same loop as K - 1 steps of about 14 tiny
// tensor operations each (fusion/associate.py `claim_plain`): some 430
// launches a call, behind 6-7 ms of host dispatch a frame on an H100
// machine's host, which set the pace of every fused frame. Here the whole
// of it is one launch.
//
// Same contract as `claim_plain`: prob f32 [K, K] (m, n), m_valid u8 [K],
// npix f32 [K], first_idx i64 [K] and num_objs i32 [] in; relabel i64 [K]
// and new_num_objs i32 [] out. Every step is a comparison or an integer
// step on the f32 values torch computed, so the outputs equal the plain
// version's bit for bit:
//   1. each id m (a thread) takes the row max of prob[m] and the first n
//      that holds it (NaN counts as the largest, the first one wins, as
//      torch's max and argmax);
//   2. accepted[m] = m_valid[m] && best_p[m] > threshold (3 * prior,
//      rounded to f32 by the caller as torch rounds the scalar);
//   3. thread 0 walks m = 1 .. K - 1 in order over an owner / owner-prob
//      table in shared memory: m takes n = best_n[m] if n is free or its
//      owner's prob is lower (tsdf.cu:352-364);
//   4. rev[m] = the first n that m owns, or -1;
//   5. ids present but unowned take fresh ids in raster order of their
//      first pixel: each thread counts the keys below its own (the stable
//      rank of torch's double argsort);
//   6. relabel[0] = 0, and new_num_objs = num_objs + the fresh count.
//
// Bound: launch latency. The work is K^2 comparisons and K^2 f32 read
// (4 KB at K = 32) for K i64 written; one block of K threads (one warp at
// K = 32), the sequential claim in one thread over shared memory, which is
// K steps of a few instructions. Nothing is read back to the host.

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_K 1024

__global__ void __launch_bounds__(MAX_K)
    associate_kernel(const float* __restrict__ prob,
                     const uint8_t* __restrict__ m_valid,
                     const float* __restrict__ npix,
                     const long long* __restrict__ first_idx,
                     const int* __restrict__ num_objs, float threshold,
                     long long P, int K, long long* __restrict__ relabel,
                     int* __restrict__ new_num_objs) {
  __shared__ int best_n[MAX_K];
  __shared__ float best_p[MAX_K];
  __shared__ uint8_t accepted[MAX_K];
  __shared__ int owner[MAX_K];
  __shared__ float oprob[MAX_K];
  __shared__ long long key[MAX_K];
  const int m = threadIdx.x;

  // 1-2. row max and its first index; accepted
  const float* row = prob + (size_t)m * K;
  float bp = row[0];
  int bn = 0;
  for (int n = 1; n < K; ++n) {
    const float v = row[n];
    if (v > bp || (isnan(v) && !isnan(bp))) {
      bp = v;
      bn = n;
    }
  }
  best_n[m] = bn;
  best_p[m] = bp;
  accepted[m] = m_valid[m] && bp > threshold;
  owner[m] = -1;
  oprob[m] = 0.f;
  __syncthreads();

  // 3. the greedy claim, in ascending m
  if (m == 0) {
    for (int i = 1; i < K; ++i) {
      if (!accepted[i]) continue;
      const int n = best_n[i];
      if (owner[n] < 0 || oprob[n] < best_p[i]) {
        owner[n] = i;
        oprob[n] = best_p[i];
      }
    }
  }
  __syncthreads();

  // 4. the n this id owns
  int rev = -1;
  for (int n = 0; n < K; ++n) {
    if (owner[n] == m) {
      rev = n;
      break;
    }
  }

  // 5. fresh ids in raster order of first pixel
  const bool needs_new = m >= 1 && npix[m] > 0.f && rev < 0;
  const long long k = needs_new ? first_idx[m] : P + m;
  key[m] = k;
  const int n_new = __syncthreads_count(needs_new);
  long long rank = 0;
  for (int j = 0; j < K; ++j) {
    const long long kj = key[j];
    rank += kj < k || (kj == k && j < m);
  }

  // 6. the relabel table and the new count
  const long long base = num_objs[0];
  relabel[m] = m == 0 ? 0 : (rev >= 0 ? rev : (needs_new ? base + rank : m));
  if (m == 0) *new_num_objs = (int)(base + n_new);
}

// prob f32 [K, K], m_valid u8 [K], npix f32 [K], first_idx i64 [K],
// num_objs i32 [1] in; relabel i64 [K], new_num_objs i32 [1] out. K <= 1024.
extern "C" int associate_cuda(const float* prob, const uint8_t* m_valid,
                              const float* npix, const long long* first_idx,
                              const int* num_objs, float threshold,
                              long long P, int K, long long* relabel,
                              int* new_num_objs, void* stream) {
  if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  associate_kernel<<<1, K, 0, (cudaStream_t)stream>>>(
      prob, m_valid, npix, first_idx, num_objs, threshold, P, K, relabel,
      new_num_objs);
  return (int)cudaGetLastError();
}
