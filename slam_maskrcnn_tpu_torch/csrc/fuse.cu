// TSDF fusion of one or two RGB-D + instance-mask frames, one thread per
// voxel.
//
// `fuse_kernel` replaces the TPU kernel `_fuse_kernel`
// (slam_maskrcnn_tpu/ops/pallas/fuse_kernel.py, reached through
// fuse_frame_blocked_impl), including its escalation passes
// (`_compacted_pass`): a voxel-parallel gather needs no per-block image
// rect, so every voxel is handled by the same thread body, as in the
// reference CUDA kernel (src/SfM_CUDA/tsdf.cu:18-70).
//
// `fuse_pair_kernel` replaces the same TPU kernel in its paired form
// (`_fuse_kernel(pair=True)`, reached through fuse_frames2_blocked_prepped
// and fuse_frames2_blocked_impl, with the two pass-B launches that follow
// it): frame 1's update, then frame 2's, per voxel, in one pass over the
// state. Both kernels call the one `frame_update` below, so the pair is
// bit-identical to two single launches by construction.
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
// Bound on an H100: memory, by the count of bytes. Per voxel the kernel
// reads the depth pixel of its projection; only voxels that pass the depth
// tests read and write diff and weight (16 B), and only gated voxels read
// and write color and one histogram bin (10 B). Threads of a warp are
// consecutive z, so their state accesses are coalesced; pixel reads of
// neighbouring voxels hit the same cache lines. The pair reads each frame
// once, moves diff and weight once (16 B) for a voxel valid in either frame
// and color and a bin (10 B) per gated update, against ~40 flops of
// projection (two frames) for each of the X*Y*Z voxels. What the single
// kernel measures is the projection of every voxel, not the state traffic,
// so the pair saves the second launch's state round trip and little else.

#include <cstdint>
#include <cuda_runtime.h>

struct FuseParams {
  float ax[3], ay[3], az[3], base[3];
  float fx, fy, cx, cy;
  float mu, depth_scale, gate;
};

// A voxel's state in registers: loaded from memory at most once (diff and
// weight at the first valid frame, color at the first gated one).
struct VoxelRegs {
  float diff;
  int32_t w;
  int c[3];
  bool have_dw, have_color;
};

// One frame's update of voxel i = (gx, gy, gz) on the registers `r`; the
// histogram vote goes straight to memory (u16 wrap-around add).
__device__ __forceinline__ void frame_update(
    VoxelRegs& r, long long i, float gx, float gy, float gz,
    const float* __restrict__ diff, const uint8_t* __restrict__ color,
    const int32_t* __restrict__ weight, uint16_t* __restrict__ hist, int K,
    const uint16_t* __restrict__ depth, const uint8_t* __restrict__ rgb,
    const uint8_t* __restrict__ mask, int H, int W, const FuseParams& p) {
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

  if (!r.have_dw) {
    r.diff = diff[i];
    r.w = weight[i];
    r.have_dw = true;
  }
  const int32_t w = r.w;
  const float wt = (float)w;
  r.diff = (r.diff * wt + dn) / (wt + 1.0f);
  r.w = w + 1;
  if (!(dn < p.gate)) return;

  if (!r.have_color) {
    for (int c = 0; c < 3; ++c) r.c[c] = color[i * 3 + c];
    r.have_color = true;
  }
  // integer truncating running mean per byte (tsdf.cu:59)
  for (int c = 0; c < 3; ++c)
    r.c[c] = (r.c[c] * w + (int)rgb[pix * 3 + c]) / (w + 1);
  int m = mask[pix];
  m = m < K ? m : K - 1;
  hist[i * K + m] = (uint16_t)(hist[i * K + m] + 1);
}

__device__ __forceinline__ void store_voxel(const VoxelRegs& r, long long i,
                                            float* __restrict__ diff,
                                            uint8_t* __restrict__ color,
                                            int32_t* __restrict__ weight) {
  if (r.have_dw) {
    diff[i] = r.diff;
    weight[i] = r.w;
  }
  if (r.have_color)
    for (int c = 0; c < 3; ++c) color[i * 3 + c] = (uint8_t)r.c[c];
}

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
  VoxelRegs r;
  r.have_dw = r.have_color = false;
  frame_update(r, i, (float)x, (float)y, (float)z, diff, color, weight, hist,
               K, depth, rgb, mask, H, W, p);
  store_voxel(r, i, diff, color, weight);
}

__global__ void fuse_pair_kernel(float* __restrict__ diff,
                                 uint8_t* __restrict__ color,
                                 int32_t* __restrict__ weight,
                                 uint16_t* __restrict__ hist,
                                 int X, int Y, int Z, int K,
                                 const uint16_t* __restrict__ depth1,
                                 const uint8_t* __restrict__ rgb1,
                                 const uint8_t* __restrict__ mask1,
                                 FuseParams p1,
                                 const uint16_t* __restrict__ depth2,
                                 const uint8_t* __restrict__ rgb2,
                                 const uint8_t* __restrict__ mask2,
                                 FuseParams p2, int H, int W) {
  const long long n = (long long)X * Y * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long t = i / Z;
  const int y = (int)(t % Y);
  const int x = (int)(t / Y);
  const float gx = (float)x, gy = (float)y, gz = (float)z;
  VoxelRegs r;
  r.have_dw = r.have_color = false;
  // frame 1, then frame 2 on its result; both may vote in the same bin
  frame_update(r, i, gx, gy, gz, diff, color, weight, hist, K, depth1, rgb1,
               mask1, H, W, p1);
  frame_update(r, i, gx, gy, gz, diff, color, weight, hist, K, depth2, rgb2,
               mask2, H, W, p2);
  store_voxel(r, i, diff, color, weight);
}

static FuseParams unpack_params(const float* params) {
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
  return p;
}

extern "C" int fuse_frame_cuda(float* diff, uint8_t* color, int32_t* weight,
                               uint16_t* hist, int X, int Y, int Z, int K,
                               const uint16_t* depth, const uint8_t* rgb,
                               const uint8_t* mask, int H, int W,
                               const float* params, void* stream) {
  const long long n = (long long)X * Y * Z;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fuse_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      diff, color, weight, hist, X, Y, Z, K, depth, rgb, mask, H, W,
      unpack_params(params));
  return (int)cudaGetLastError();
}

extern "C" int fuse_frames2_cuda(float* diff, uint8_t* color, int32_t* weight,
                                 uint16_t* hist, int X, int Y, int Z, int K,
                                 const uint16_t* depth1, const uint8_t* rgb1,
                                 const uint8_t* mask1, const float* params1,
                                 const uint16_t* depth2, const uint8_t* rgb2,
                                 const uint8_t* mask2, const float* params2,
                                 int H, int W, void* stream) {
  const long long n = (long long)X * Y * Z;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fuse_pair_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      diff, color, weight, hist, X, Y, Z, K, depth1, rgb1, mask1,
      unpack_params(params1), depth2, rgb2, mask2, unpack_params(params2), H,
      W);
  return (int)cudaGetLastError();
}
