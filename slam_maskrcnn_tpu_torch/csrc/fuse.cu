// TSDF fusion of one RGB-D + instance-mask frame, one thread per voxel.
//
// Replaces the TPU kernel `_fuse_kernel` (slam_maskrcnn_tpu/ops/pallas/
// fuse_kernel.py, reached through fuse_frame_blocked_impl), including its
// escalation passes (`_compacted_pass`): a voxel-parallel gather needs no
// per-block image rect, so every voxel is handled by the same thread body,
// as in the reference CUDA kernel (src/SfM_CUDA/tsdf.cu:18-70).
//
// Arithmetic follows the Pallas kernel, not fusion/fuse.py:
//   p = base + ax*gx + ay*gy + az*gz   (base = E[:3,:3] @ vol_start + E[:3,3],
//                                      ax = E[:3,0] * voxel.x, ...)
//   u = floor((fx*px + cx*pz) / safe_z), v likewise
//   diff' = (diff*wt + dn) / (wt + 1)
// Build with --fmad=false: a contracted multiply-add rounds once instead of
// twice, and then voxels on a pixel edge or a gate threshold land on the
// other side than in the plain PyTorch version, so integer state (weight,
// color, histogram) would stop being bit-equal.
//
// State layout: dense C-order [X, Y, Z] for diff (f32), weight (i32),
// [X, Y, Z, 3] u8 for color and [X, Y, Z, K] u16 for the histogram. The
// update is in place.
//
// Bound on an H100: memory. Per voxel the kernel reads the depth pixel of
// its projection; only voxels that pass the depth tests read and write
// diff and weight (16 B), and only gated voxels read and write color and
// one histogram bin (10 B). Threads of a warp are consecutive z, so their
// state accesses are coalesced; pixel reads of neighbouring voxels hit the
// same cache lines.

#include <cstdint>
#include <cuda_runtime.h>

struct FuseParams {
  float ax[3], ay[3], az[3], base[3];
  float fx, fy, cx, cy;
  float mu, depth_scale, gate;
};

__global__ void fuse_kernel(float* __restrict__ diff,
                            uint8_t* __restrict__ color,
                            int32_t* __restrict__ weight,
                            uint16_t* __restrict__ hist,
                            int X, int Y, int Z, int K,
                            const uint16_t* __restrict__ depth,
                            const uint8_t* __restrict__ rgb,
                            const uint8_t* __restrict__ mask,
                            int H, int W, FuseParams p) {
  const long long n = (long long)X * Y * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long t = i / Z;
  const int y = (int)(t % Y);
  const int x = (int)(t / Y);
  const float gx = (float)x, gy = (float)y, gz = (float)z;

  const float px = p.base[0] + p.ax[0] * gx + p.ay[0] * gy + p.az[0] * gz;
  const float py = p.base[1] + p.ax[1] * gx + p.ay[1] * gy + p.az[1] * gz;
  const float pz = p.base[2] + p.ax[2] * gx + p.ay[2] * gy + p.az[2] * gz;
  const float safe_z = fabsf(pz) < 1e-9f ? 1e-9f : pz;
  const float uf = floorf((p.fx * px + p.cx * pz) / safe_z);
  const float vf = floorf((p.fy * py + p.cy * pz) / safe_z);
  // float compares: the same test as the integer one for every in-range
  // value, and no undefined conversion for voxels near the camera plane
  if (!(uf >= 0.0f && uf < (float)W && vf >= 0.0f && vf < (float)H &&
        pz > 0.0f))
    return;
  const int pix = (int)vf * W + (int)uf;

  const uint16_t d_raw = depth[pix];
  if (d_raw == 0) return;
  const float diff_m = (float)d_raw / p.depth_scale - pz;
  if (!(diff_m > -p.mu)) return;
  const float dn = fminf(diff_m, p.mu) / p.mu;

  const int32_t w = weight[i];
  const float wt = (float)w;
  diff[i] = (diff[i] * wt + dn) / (wt + 1.0f);
  weight[i] = w + 1;
  if (!(dn < p.gate)) return;

  // integer truncating running mean per byte (tsdf.cu:59)
  for (int c = 0; c < 3; ++c) {
    const int old = color[i * 3 + c];
    color[i * 3 + c] = (uint8_t)((old * w + (int)rgb[pix * 3 + c]) / (w + 1));
  }
  int m = mask[pix];
  m = m < K ? m : K - 1;
  hist[i * K + m] = (uint16_t)(hist[i * K + m] + 1);
}

extern "C" int fuse_frame_cuda(float* diff, uint8_t* color, int32_t* weight,
                               uint16_t* hist, int X, int Y, int Z, int K,
                               const uint16_t* depth, const uint8_t* rgb,
                               const uint8_t* mask, int H, int W,
                               const float* params, void* stream) {
  FuseParams p;
  for (int k = 0; k < 3; ++k) {
    p.ax[k] = params[k];
    p.ay[k] = params[3 + k];
    p.az[k] = params[6 + k];
    p.base[k] = params[9 + k];
  }
  p.fx = params[12];
  p.fy = params[13];
  p.cx = params[14];
  p.cy = params[15];
  p.mu = params[16];
  p.depth_scale = params[17];
  p.gate = params[18];
  const long long n = (long long)X * Y * Z;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fuse_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      diff, color, weight, hist, X, Y, Z, K, depth, rgb, mask, H, W, p);
  return (int)cudaGetLastError();
}
