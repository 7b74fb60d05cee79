// TSDF fusion of one or two RGB-D + instance-mask frames by 8 x 8 x 32
// bricks of voxels (four bricks, neighbours in z, to a thread block), each
// brick classified per frame before any of its voxels is touched.
//
// `fuse_kernel` replaces the TPU kernel `_fuse_kernel`
// (slam_maskrcnn_tpu/ops/pallas/fuse_kernel.py, reached through
// fuse_frame_blocked_impl) with its escalation passes (`_compacted_pass`)
// and the host-side part that feeds it, `_block_origins`: the sorting of
// blocks, before launch, into skip / free / full lookup from their 8
// projected corners and a 32 x 32-pooled depth min / max pyramid. The
// TPU's image rects are not carried over (a gather needs none); the
// classification is, because it is what keeps work off the chip.
// `fuse_pair_kernel` replaces the same TPU kernel in its paired form
// (`_fuse_kernel(pair=True)`, reached through fuse_frames2_blocked_prepped
// and fuse_frames2_blocked_impl, with the two pass-B launches that follow
// it): frame 1's update, then frame 2's, per voxel, in one pass over the
// state. Both kernels are one body (`fuse_brick<NF>`) around the one
// `full_update` and the one `free_update`, so the pair is bit-identical to
// two single launches by construction.
//
// The launch (`fuse_frame_cuda`, `fuse_frames2_cuda`) is two kernels on one
// stream:
// 1. `depth_tiles_kernel`: per 32 x 32 tile of each depth image the minimum
//    (0 where any pixel is 0) and the maximum (15 x 20 tiles at 480 x 640).
// 2. `fuse_kernel` / `fuse_pair_kernel`, a 3-D grid over the bricks (ragged
//    edges masked). A block first classifies its four bricks, one warp per
//    brick and frame side by side, from the brick's 8 corner voxels in
//    camera space, then does the bricks in turn (four to a block because a
//    block that only skips costs more to launch than to run):
//    - skip: all corners behind the camera; or all in front and the
//      projected box misses the image; or all in front and the deepest
//      pixel of the covered tiles still puts every voxel at
//      depth - z <= -mu. The block does nothing for that frame.
//    - free: all corners in front, the projected box inside the image, no
//      hole in the covered tiles and their nearest pixel at depth - z >= mu
//      for every voxel. Then every voxel is valid with dn == 1.0f exactly
//      and not gated (1 < gate is false; where gate > 1 no brick is free):
//      diff' = (diff*wt + 1)/(wt + 1), weight + 1, with no projection, no
//      pixel read, no color, no histogram. A brick with no full frame
//      streams diff and weight 16 B a thread.
//    - full: everything else, including every brick that straddles the
//      camera plane or comes nearer to it than z_near (the hull of the
//      front corners does not bound those). Per voxel the dense update.
//    The tests are conservative: a brick is skip or free only where the
//    per-voxel f32 arithmetic could not decide otherwise. The slacks
//    (z_slack, z_near, px_slack) are computed per frame on the host from the
//    magnitude of the camera constants (fusion/fuse.py `brick_slacks`) and
//    arrive with the parameters; the yardstick is the dense plain version
//    (`fuse_frame_plain`), bit for bit. Each brick's class is written out
//    (int8, one per brick and frame) so that it can be held against
//    `brick_classes_plain`.
//
// Arithmetic of the full update follows the Pallas kernel:
//   p = base + ax*gx + ay*gy + az*gz   (base = E[:3,:3] @ vol_start + E[:3,3],
//                                      ax = E[:3,0] * voxel.x, ...)
//   u = floor((fx*px + cx*pz) / safe_z), v likewise
//   diff' = (diff*wt + dn) / (wt + 1)
// The products ay*gy and az*gz are hoisted out of the loop over x; the
// additions keep their order, so the rounding is unchanged. Build with
// --fmad=false: a contracted multiply-add rounds once instead of twice, and
// then voxels on a pixel edge or a gate threshold land on the other side
// than in the plain PyTorch version, so integer state (weight, color,
// histogram) would stop being bit-equal.
//
// State layout: dense C-order [X, Y, Z] for diff (f32), weight (i32),
// [X, Y, Z, 3] u8 for color and [X, Y, Z, K] u16 for the histogram, updated
// in place. A warp is one 32-voxel z-run (128 B of diff or of weight). All
// index arithmetic is 32-bit (the wrapper refuses volumes of 2^31 / 3
// voxels or more); the only 64-bit value is the histogram offset i * K.
// There is no division or modulo on the per-voxel path but the two of the
// projection and the one of the running mean.
//
// Bound on an H100: memory, by the count of bytes: diff and weight (16 B)
// of every voxel a frame updates, color and one histogram bin (10 B) of
// every gated one, each frame once. No TMA, no wgmma, no clusters: there is
// no product; the pixel gathers of a full brick fall in a footprint of a
// few KB that L1 serves; what is left after the classification is the
// state traffic of the free and full bricks (coalesced 128 B runs) and the
// instruction rate of the full bricks (about 70 instructions a voxel, two
// IEEE divisions among them). Unrolling the loop over x (2, 4, 8 voxels a
// thread in flight) was measured and is slower: the full bricks are bound
// by their scattered color and histogram sectors, not by latency.

#include <cstdint>
#include <cuda_runtime.h>

// Brick and tile shape: mirrored in fusion/fuse.py (BRICK, DEPTH_TILE),
// which computes the plain classes; change both together.
#define BRICK_X 8
#define BRICK_Y 8
#define BRICK_Z 32
#define TILE 32
#define FUSE_THREADS 256  // BRICK_Y warps: warp = y, lane = z, loop over x
#define FUSE_GROUP 4      // bricks a block, neighbours in z

#define CLS_SKIP 0
#define CLS_FULL 1
#define CLS_FREE 2

struct FuseParams {
  float ax[3], ay[3], az[3], base[3];
  float fx, fy, cx, cy;
  float mu, depth_scale, gate;
  float z_slack, z_near, px_slack;
};

struct Frame {
  const uint16_t* depth;
  const uint8_t* rgb;
  const uint8_t* mask;
  const int32_t* tile_min;  // [th, tw]
  const int32_t* tile_max;  // [th, tw]
  int8_t* classes;          // [nbx, nby, nbz]
  FuseParams p;
};

template <int NF>
struct Frames {
  Frame f[NF];
};

// ---- pass 1: min and max of each 32 x 32 depth tile (edge tiles over the
// pixels they have). Grid (tw, th, frames), 256 threads: 32 columns x 8 rows.
__global__ void depth_tiles_kernel(const uint16_t* __restrict__ depth0,
                                   const uint16_t* __restrict__ depth1, int H,
                                   int W, int32_t* __restrict__ tiles) {
  __shared__ unsigned s_mn[8], s_mx[8];
  const int tw = gridDim.x, th = gridDim.y;
  const uint16_t* depth = blockIdx.z == 0 ? depth0 : depth1;
  int32_t* out = tiles + (int)blockIdx.z * 2 * th * tw;
  const int lx = threadIdx.x & 31, ly = threadIdx.x >> 5;
  const int u = blockIdx.x * TILE + lx;
  unsigned mn = 0xFFFFu, mx = 0u;
  if (u < W) {
    for (int r = ly; r < TILE; r += 8) {
      const int v = blockIdx.y * TILE + r;
      if (v < H) {
        const unsigned d = depth[v * W + u];
        mn = min(mn, d);
        mx = max(mx, d);
      }
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lx == 0) {
    s_mn[ly] = mn;
    s_mx[ly] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) {
      mn = min(mn, s_mn[w]);
      mx = max(mx, s_mx[w]);
    }
    const int t = blockIdx.y * tw + blockIdx.x;
    out[t] = (int32_t)mn;
    out[th * tw + t] = (int32_t)mx;
  }
}

// ---- the class of the brick with corner voxels (x0..x1, y0..y1, z0..z1)
// for one frame; run by all 32 lanes of a warp (the tile scan is split over
// the lanes). Same arithmetic as fusion/fuse.py `brick_classes_plain`.
__device__ __forceinline__ int classify_brick(const Frame& fr, float x0,
                                              float x1, float y0, float y1,
                                              float z0, float z1, int H,
                                              int W, int lane) {
  const FuseParams& p = fr.p;
  float cpx[8], cpy[8], cpz[8];
  float zmin = INFINITY, zmax = -INFINITY;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float gx = (c & 4) ? x1 : x0;
    const float gy = (c & 2) ? y1 : y0;
    const float gz = (c & 1) ? z1 : z0;
    cpx[c] = p.base[0] + p.ax[0] * gx + p.ay[0] * gy + p.az[0] * gz;
    cpy[c] = p.base[1] + p.ax[1] * gx + p.ay[1] * gy + p.az[1] * gz;
    cpz[c] = p.base[2] + p.ax[2] * gx + p.ay[2] * gy + p.az[2] * gz;
    zmin = fminf(zmin, cpz[c]);
    zmax = fmaxf(zmax, cpz[c]);
  }
  if (zmax < -p.z_slack) return CLS_SKIP;     // every voxel has z <= 0
  if (!(zmin >= p.z_near)) return CLS_FULL;   // straddles or hugs the plane
  float umin = INFINITY, umax = -INFINITY, vmin = INFINITY, vmax = -INFINITY;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float u = (p.fx * cpx[c] + p.cx * cpz[c]) / cpz[c];
    const float v = (p.fy * cpy[c] + p.cy * cpz[c]) / cpz[c];
    umin = fminf(umin, u);
    umax = fmaxf(umax, u);
    vmin = fminf(vmin, v);
    vmax = fmaxf(vmax, v);
  }
  const float ulo = umin - p.px_slack, uhi = umax + p.px_slack;
  const float vlo = vmin - p.px_slack, vhi = vmax + p.px_slack;
  const float fW = (float)W, fH = (float)H;
  if (uhi < 0.0f || ulo >= fW || vhi < 0.0f || vlo >= fH) return CLS_SKIP;
  // the 32 x 32 tiles that hold every pixel a voxel of the brick can hit
  const int tw = (W + TILE - 1) / TILE;
  const int tu0 = (int)fmaxf(ulo, 0.0f) / TILE;
  const int tu1 = (int)fminf(uhi, fW - 1.0f) / TILE;
  const int tv0 = (int)fmaxf(vlo, 0.0f) / TILE;
  const int tv1 = (int)fminf(vhi, fH - 1.0f) / TILE;
  const int nu = tu1 - tu0 + 1, nt = nu * (tv1 - tv0 + 1);
  int dmin = 0xFFFF, dmax = 0;
  for (int t = lane; t < nt; t += 32) {
    const int tv = tv0 + t / nu, tu = tu0 + t % nu;
    dmin = min(dmin, __ldg(fr.tile_min + tv * tw + tu));
    dmax = max(dmax, __ldg(fr.tile_max + tv * tw + tu));
  }
  dmin = __reduce_min_sync(0xffffffffu, dmin);
  dmax = __reduce_max_sync(0xffffffffu, dmax);
  if (dmax == 0) return CLS_SKIP;             // no depth under the brick
  if ((float)dmax / p.depth_scale - (zmin - p.z_slack) <= -p.mu)
    return CLS_SKIP;                          // all behind the surface
  const bool inside = ulo >= 0.0f && uhi < fW && vlo >= 0.0f && vhi < fH;
  if (inside && dmin > 0 && !(1.0f < p.gate) &&
      (float)dmin / p.depth_scale - (zmax + p.z_slack) >= p.mu)
    return CLS_FREE;                          // all in front of the band
  return CLS_FULL;
}

// A voxel's state in registers: loaded from memory at most once (diff and
// weight at the first frame that updates it, color at the first gated one).
struct VoxelRegs {
  float diff;
  int32_t w;
  int c[3];
  bool have_dw, have_color;
};

// The running mean of a free voxel: dn == 1.0f, no gate.
__device__ __forceinline__ void free_step(float& d, int32_t& w) {
  const float wt = (float)w;
  d = (d * wt + 1.0f) / (wt + 1.0f);
  w = w + 1;
}

__device__ __forceinline__ void load_dw(VoxelRegs& r, int i,
                                        const float* __restrict__ diff,
                                        const int32_t* __restrict__ weight) {
  if (!r.have_dw) {
    r.diff = diff[i];
    r.w = weight[i];
    r.have_dw = true;
  }
}

// One frame's update of voxel i in a free brick.
__device__ __forceinline__ void free_update(VoxelRegs& r, int i,
                                            const float* __restrict__ diff,
                                            const int32_t* __restrict__ weight) {
  load_dw(r, i, diff, weight);
  free_step(r.diff, r.w);
}

// One frame's update of voxel i in a full brick, at camera-space position
// (px, py, pz); the histogram vote goes straight to memory (u16 wrap-around
// add).
__device__ __forceinline__ void full_update(
    VoxelRegs& r, int i, float px, float py, float pz,
    const float* __restrict__ diff, const uint8_t* __restrict__ color,
    const int32_t* __restrict__ weight, uint16_t* __restrict__ hist, int K,
    const Frame& fr, int H, int W) {
  const FuseParams& p = fr.p;
  const float safe_z = fabsf(pz) < 1e-9f ? 1e-9f : pz;
  const float uf = floorf((p.fx * px + p.cx * pz) / safe_z);
  const float vf = floorf((p.fy * py + p.cy * pz) / safe_z);
  // float compares: the same test as the integer one for every in-range
  // value, and no undefined conversion for voxels near the camera plane
  if (!(uf >= 0.0f && uf < (float)W && vf >= 0.0f && vf < (float)H &&
        pz > 0.0f))
    return;
  const int pix = (int)vf * W + (int)uf;

  const uint16_t d_raw = fr.depth[pix];
  if (d_raw == 0) return;
  const float diff_m = (float)d_raw / p.depth_scale - pz;
  if (!(diff_m > -p.mu)) return;
  const float dn = fminf(diff_m, p.mu) / p.mu;

  load_dw(r, i, diff, weight);
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
    r.c[c] = (r.c[c] * w + (int)fr.rgb[pix * 3 + c]) / (w + 1);
  int m = fr.mask[pix];
  m = m < K ? m : K - 1;
  uint16_t* bin = hist + ((long long)i * K + m);
  *bin = (uint16_t)(*bin + 1);
}

__device__ __forceinline__ void store_voxel(const VoxelRegs& r, int i,
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

// One brick (origin x0, y0, z0) through NF frames of classes `cls`, in order.
template <int NF>
__device__ __forceinline__ void fuse_brick(float* __restrict__ diff,
                                           uint8_t* __restrict__ color,
                                           int32_t* __restrict__ weight,
                                           uint16_t* __restrict__ hist, int X,
                                           int Y, int Z, int K,
                                           const Frames<NF>& frames, int H,
                                           int W, int x0, int y0, int z0,
                                           int xoff, const int (&cls)[NF]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n_full = 0, n_free = 0;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    n_full += cls[f] == CLS_FULL;
    n_free += cls[f] == CLS_FREE;
  }
  if (n_full + n_free == 0) return;

  if (n_full == 0 && (Z & 3) == 0 &&
      ((((uintptr_t)diff) | ((uintptr_t)weight)) & 15) == 0) {
    // free frames only: stream diff and weight, 4 z a thread
    const int groups = BRICK_X * BRICK_Y * (BRICK_Z / 4);
    for (int g = threadIdx.x; g < groups; g += FUSE_THREADS) {
      const int run = g / (BRICK_Z / 4);
      const int x = x0 + run / BRICK_Y, y = y0 + run % BRICK_Y;
      const int z = z0 + (g % (BRICK_Z / 4)) * 4;
      if (x >= X || y >= Y || z >= Z) continue;
      const int i = (x * Y + y) * Z + z;
      float4 d = *reinterpret_cast<const float4*>(diff + i);
      int4 w = *reinterpret_cast<const int4*>(weight + i);
      for (int f = 0; f < n_free; ++f) {
        free_step(d.x, w.x);
        free_step(d.y, w.y);
        free_step(d.z, w.z);
        free_step(d.w, w.w);
      }
      *reinterpret_cast<float4*>(diff + i) = d;
      *reinterpret_cast<int4*>(weight + i) = w;
    }
    return;
  }

  const int y = y0 + warp, z = z0 + lane;
  if (y >= Y || z >= Z) return;
  const float gy = (float)y, gz = (float)z;
  float aygy[NF][3], azgz[NF][3];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      aygy[f][k] = frames.f[f].p.ay[k] * gy;
      azgz[f][k] = frames.f[f].p.az[k] * gz;
    }
  const int x_end = min(x0 + BRICK_X, X);
  for (int x = x0; x < x_end; ++x) {
    const float gx = (float)(x + xoff);
    const int i = (x * Y + y) * Z + z;
    VoxelRegs r;
    r.have_dw = r.have_color = false;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (cls[f] == CLS_FULL) {
        const FuseParams& p = frames.f[f].p;
        const float px = p.base[0] + p.ax[0] * gx + aygy[f][0] + azgz[f][0];
        const float py = p.base[1] + p.ax[1] * gx + aygy[f][1] + azgz[f][1];
        const float pz = p.base[2] + p.ax[2] * gx + aygy[f][2] + azgz[f][2];
        full_update(r, i, px, py, pz, diff, color, weight, hist, K,
                    frames.f[f], H, W);
      } else if (cls[f] == CLS_FREE) {
        free_update(r, i, diff, weight);
      }
    }
    store_voxel(r, i, diff, color, weight);
  }
}

// The body of both kernels: the block's FUSE_GROUP bricks (neighbours in z)
// are classified first, one warp per brick and frame, then done in turn.
template <int NF>
__device__ __forceinline__ void fuse_block(float* __restrict__ diff,
                                           uint8_t* __restrict__ color,
                                           int32_t* __restrict__ weight,
                                           uint16_t* __restrict__ hist, int X,
                                           int Y, int Z, int K,
                                           const Frames<NF>& frames, int H,
                                           int W, int xoff) {
  __shared__ int s_cls[FUSE_GROUP][NF];
  const int nbz = (Z + BRICK_Z - 1) / BRICK_Z;
  const int x0 = blockIdx.z * BRICK_X, y0 = blockIdx.y * BRICK_Y;
  const int bz0 = blockIdx.x * FUSE_GROUP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int slot = warp; slot < FUSE_GROUP * NF; slot += FUSE_THREADS / 32) {
    const int g = slot / NF, f = slot % NF, bz = bz0 + g;
    if (bz >= nbz) continue;
    const int z0 = bz * BRICK_Z;
    int c = 0;
#pragma unroll
    for (int ff = 0; ff < NF; ++ff)   // a static index into the parameters
      if (ff == f)
        c = classify_brick(
            frames.f[ff], (float)(x0 + xoff),
            (float)(min(x0 + BRICK_X - 1, X - 1) + xoff),
            (float)y0, (float)min(y0 + BRICK_Y - 1, Y - 1), (float)z0,
            (float)min(z0 + BRICK_Z - 1, Z - 1), H, W, lane);
    if (lane == 0) {
      s_cls[g][f] = c;
#pragma unroll
      for (int ff = 0; ff < NF; ++ff)
        if (ff == f)
          frames.f[ff].classes[((int)blockIdx.z * gridDim.y + blockIdx.y) *
                                   nbz + bz] = (int8_t)c;
    }
  }
  __syncthreads();
  for (int g = 0; g < FUSE_GROUP && bz0 + g < nbz; ++g) {
    int cls[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) cls[f] = s_cls[g][f];
    fuse_brick<NF>(diff, color, weight, hist, X, Y, Z, K, frames, H, W, x0, y0,
                   (bz0 + g) * BRICK_Z, xoff, cls);
  }
}

__global__ void __launch_bounds__(FUSE_THREADS)
    fuse_kernel(float* __restrict__ diff, uint8_t* __restrict__ color,
                int32_t* __restrict__ weight, uint16_t* __restrict__ hist,
                int X, int Y, int Z, int K,
                const __grid_constant__ Frames<1> frames, int H, int W,
                int xoff) {
  fuse_block<1>(diff, color, weight, hist, X, Y, Z, K, frames, H, W, xoff);
}

__global__ void __launch_bounds__(FUSE_THREADS)
    fuse_pair_kernel(float* __restrict__ diff, uint8_t* __restrict__ color,
                     int32_t* __restrict__ weight,
                     uint16_t* __restrict__ hist, int X, int Y, int Z, int K,
                     const __grid_constant__ Frames<2> frames, int H, int W) {
  fuse_block<2>(diff, color, weight, hist, X, Y, Z, K, frames, H, W, 0);
}

static Frame make_frame(const uint16_t* depth, const uint8_t* rgb,
                        const uint8_t* mask, const float* params,
                        const int32_t* tiles, int8_t* classes, int n_tiles,
                        int n_bricks, int slot) {
  Frame fr;
  fr.depth = depth;
  fr.rgb = rgb;
  fr.mask = mask;
  fr.tile_min = tiles + (size_t)slot * 2 * n_tiles;
  fr.tile_max = fr.tile_min + n_tiles;
  fr.classes = classes + (size_t)slot * n_bricks;
  FuseParams& p = fr.p;
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
  p.z_slack = params[19];
  p.z_near = params[20];
  p.px_slack = params[21];
  return fr;
}

// params: float32 [22] per frame (fuse_params + brick_slacks); tiles: i32
// scratch [frames, 2, th, tw]; classes: i8 out [frames, nbx, nby, nbz].
// x0 (single frame): the volume is the x-slab [x0, x0 + X) of a larger one
// whose camera constants `params` are; its voxels take their global x.
extern "C" int fuse_frame_cuda(float* diff, uint8_t* color, int32_t* weight,
                               uint16_t* hist, int X, int Y, int Z, int K,
                               const uint16_t* depth, const uint8_t* rgb,
                               const uint8_t* mask, int H, int W,
                               const float* params, int32_t* tiles,
                               int8_t* classes, int x0, void* stream) {
  const int tw = (W + TILE - 1) / TILE, th = (H + TILE - 1) / TILE;
  const int nbz = (Z + BRICK_Z - 1) / BRICK_Z;
  const dim3 grid((nbz + FUSE_GROUP - 1) / FUSE_GROUP,
                  (Y + BRICK_Y - 1) / BRICK_Y, (X + BRICK_X - 1) / BRICK_X);
  const int n_bricks = nbz * grid.y * grid.z;
  cudaStream_t s = (cudaStream_t)stream;
  depth_tiles_kernel<<<dim3(tw, th, 1), 256, 0, s>>>(depth, depth, H, W,
                                                      tiles);
  Frames<1> frames;
  frames.f[0] = make_frame(depth, rgb, mask, params, tiles, classes, th * tw,
                           n_bricks, 0);
  fuse_kernel<<<grid, FUSE_THREADS, 0, s>>>(diff, color, weight, hist, X, Y,
                                            Z, K, frames, H, W, x0);
  return (int)cudaGetLastError();
}

extern "C" int fuse_frames2_cuda(float* diff, uint8_t* color, int32_t* weight,
                                 uint16_t* hist, int X, int Y, int Z, int K,
                                 const uint16_t* depth1, const uint8_t* rgb1,
                                 const uint8_t* mask1, const float* params1,
                                 const uint16_t* depth2, const uint8_t* rgb2,
                                 const uint8_t* mask2, const float* params2,
                                 int H, int W, int32_t* tiles, int8_t* classes,
                                 void* stream) {
  const int tw = (W + TILE - 1) / TILE, th = (H + TILE - 1) / TILE;
  const int nbz = (Z + BRICK_Z - 1) / BRICK_Z;
  const dim3 grid((nbz + FUSE_GROUP - 1) / FUSE_GROUP,
                  (Y + BRICK_Y - 1) / BRICK_Y, (X + BRICK_X - 1) / BRICK_X);
  const int n_bricks = nbz * grid.y * grid.z;
  cudaStream_t s = (cudaStream_t)stream;
  depth_tiles_kernel<<<dim3(tw, th, 2), 256, 0, s>>>(depth1, depth2, H, W,
                                                      tiles);
  Frames<2> frames;
  frames.f[0] = make_frame(depth1, rgb1, mask1, params1, tiles, classes,
                           th * tw, n_bricks, 0);
  frames.f[1] = make_frame(depth2, rgb2, mask2, params2, tiles, classes,
                           th * tw, n_bricks, 1);
  fuse_pair_kernel<<<grid, FUSE_THREADS, 0, s>>>(diff, color, weight, hist, X,
                                                 Y, Z, K, frames, H, W);
  return (int)cudaGetLastError();
}
