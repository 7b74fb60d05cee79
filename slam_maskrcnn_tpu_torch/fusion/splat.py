"""Splat renderer and association probes.

Port of slam_maskrcnn_tpu/fusion/splat.py. The render draws the fused
surface by forward projection instead of a per-ray march
(fusion/raycast.py keeps the march as the oracle):

1. surface shell = voxels with normalized SDF in (-shell_band, 0);
2. two-level compaction before any geometry: 8x8x32 blocks that hold
   shell, then their 128-voxel rows, up to ``max_blocks`` / ``max_rows``;
3. level-2 compaction either exact (every visible shell voxel, up to
   ``max_surface``) or, with ``row_cap`` > 0, the ``row_cap`` z-nearest
   visible voxels of each row (a stable sort along the row);
4. one scatter-min of a packed key (quantized z << idx_bits | compact
   index) resolves depth and winner together;
5. shading reads each winner voxel's histogram row or color;
6. 1-px holes are closed by the minimum key of the 8 neighbours.

What is kept from the JAX package's TPU layout, and why: the volume here
is dense [X, Y, Z], but the shell is still enumerated in the blocked order
(blocks (bx, by, bz) row-major, then dx, dy, dz inside a block; a row is
one (dx, dy // 4) of a block: 4 y by 32 z voxels), with the same budgets,
because the compact index breaks ties inside one z quantum and the budgets
decide which voxels are clipped: only then do the two renders agree. What
is not kept: the 128-lane row gathers with one-hot selects
(``_gather_hist_rows`` and the color fetch), which are a plain index into
``hist.view(-1, K)`` / ``color.view(-1, 3)`` here, and the TPU-only
``approx_min_k`` candidate selection. Voxel ids are dense linear indices
(x * Y + y) * Z + z.

Cameras are float32 numpy on the host (M [3, 3], m4 [3]: s = M p + m4,
u = s_x / s_z); everything per voxel and per pixel is on the volume's
device, with no host sync. Counters (overflow, clip) are 0-d int64 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_maskrcnn_tpu_torch.fusion.fuse import _host_f32
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig, TSDFState
from slam_maskrcnn_tpu_torch.utils.profiling import sync

BX, BY, BZ = 8, 8, 32          # block geometry of the enumeration order
ROW = 128                      # voxels per row (4 y by 32 z)
ROWS_PER_BLOCK = BX * BY * BZ // ROW
BIG = 3.0e38
KEY_EMPTY = 2 ** 31 - 1

# 32-entry instance palette of the reference viewer (viewer.cu:93-126), RGB
INSTANCE_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
], dtype=np.uint8)


# ---------------------------------------------------------------- cameras

def pinhole_of_extrinsic(extrinsic, intrinsic):
    """Standard camera: s = M p + m4, u = s_x / s_z (the probe camera of
    back_proj_kernel, tsdf.cu:81-89). float32 numpy (M [3, 3], m4 [3])."""
    E = _host_f32(extrinsic)
    Km = _host_f32(intrinsic)[:3, :3]
    return Km @ E[:3, :3], Km @ E[:3, 3]


def pinhole_of_orbit(angle, dist, intrinsic):
    """The viewer's orbit camera (viewer.cu:140-146) as an exact pinhole.

    Rays are c + t * (R Ki h + tr - c). Solving for the pixel of a world
    point p: with w = R^T (p - c) and e = R^T (tr - c),
    u = fx (1 + e_z) w_x / w_z + (cx - fx e_x) (same for v): a pinhole
    with scaled focal length and shifted center."""
    angle = np.float32(angle)
    dist = np.float32(dist)
    half = np.float32(0.5)
    ca, sa = np.cos(angle), np.sin(angle)
    R = np.eye(3, dtype=np.float32)
    R[0, 0], R[0, 2], R[2, 0], R[2, 2] = ca, -sa, sa, ca
    tr = np.array([dist * sa, 0.0, dist - dist * ca], np.float32)
    c = np.array([(dist + half) * sa, 0.0,
                  (dist + half) - (dist + half) * ca], np.float32)
    e = R.T @ (tr - c)
    Km = _host_f32(intrinsic)
    fx, fy, cx, cy = Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]
    one = np.float32(1.0)
    Kp = np.zeros((3, 3), np.float32)
    Kp[2, 2] = 1.0
    Kp[0, 0], Kp[0, 2] = fx * (one + e[2]), cx - fx * e[0]
    Kp[1, 1], Kp[1, 2] = fy * (one + e[2]), cy - fy * e[1]
    M = Kp @ R.T
    m4 = -(Kp @ (R.T @ c))
    return M.astype(np.float32), m4.astype(np.float32)


# ------------------------------------------------------------ compaction

def _nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """= jnp.nonzero(mask, size=size, fill_value=fill) for a 1-D mask: the
    ascending indices of the first ``size`` true entries, padded with
    ``fill``. Static shape; the host waits once, to upload ``fill``."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(0, slot, torch.arange(n, device=mask.device))
    with sync("compact.fill"):              # a host scalar's upload
        out[size] = fill
    return out[:size]


def _block_dims(dim):
    if dim[0] % BX or dim[1] % BY or dim[2] % BZ:
        raise ValueError(f"vol_dim {tuple(dim)} must be divisible by "
                         f"{(BX, BY, BZ)}")
    return dim[0] // BX, dim[1] // BY, dim[2] // BZ


def _positions(gx, gy, gz, vol_start, voxel):
    """World positions of integer grid coordinates: start + float(g) * voxel
    per axis, in float32."""
    return (float(vol_start[0]) + gx.to(torch.float32) * float(voxel[0]),
            float(vol_start[1]) + gy.to(torch.float32) * float(voxel[1]),
            float(vol_start[2]) + gz.to(torch.float32) * float(voxel[2]))


def _compact_shell(vol: TSDFState, max_blocks: int, max_rows: int,
                   shell_band: float, x0: int = 0) -> dict:
    """State-side half of the splat: compact the surface shell to
    [max_rows, 128] rows in the blocked enumeration order and compute their
    world positions. Camera-free, so one compaction can serve many views
    (OrbitRenderer) or a probe and a render (the north-star step). ``x0``:
    ``vol`` is the x-slab at x0 of a volume whose geometry it carries; the
    positions are those of the voxels' global x, the ids local to the
    slab (parallel/sharding.py)."""
    diff = vol.diff
    X, Y, Z = diff.shape
    nbx, nby, nbz = _block_dims((X, Y, Z))
    NB = nbx * nby * nbz
    dv = diff.view(nbx, BX, nby, BY, nbz, BZ)
    shell = (diff < 0.0) & (diff > -shell_band)
    act = shell.view(nbx, BX, nby, BY, nbz, BZ).any(5).any(3).any(1)
    act = act.reshape(NB)
    del shell
    n_act = act.sum()
    bids = _nonzero_fixed(act, max_blocks, NB)
    bid_ok = bids < NB
    bids_c = bids.clamp_max(NB - 1)
    bxi = bids_c // (nbz * nby)
    byi = (bids_c // nbz) % nby
    bzi = bids_c % nbz
    # [MB, BX, BY, BZ] -> [MB * 16, 128]: the blocks' rows in (dx, dy // 4)
    # order, each row 4 y by 32 z
    diff_a = dv[bxi, :, byi, :, bzi, :].reshape(-1, ROW)
    sh_a = ((diff_a < 0.0) & (diff_a > -shell_band)
            & bid_ok.repeat_interleave(ROWS_PER_BLOCK)[:, None])
    row_any = sh_a.any(1)
    n_all = row_any.shape[0]
    rsel = _nonzero_fixed(row_any, max_rows, n_all)
    rid_ok = rsel < n_all
    rsel_c = rsel.clamp_max(n_all - 1)

    diff_r = diff_a[rsel_c]                              # [MR, 128]
    shell_r = (diff_r < 0.0) & (diff_r > -shell_band) & rid_ok[:, None]
    blk = bids_c[rsel_c // ROWS_PER_BLOCK]
    s_r = rsel_c % ROWS_PER_BLOCK
    lane = torch.arange(ROW, device=diff.device)
    vlin = s_r[:, None] * ROW + lane[None, :]            # voxel inside block
    gx = (blk // (nbz * nby))[:, None] * BX + vlin // (BY * BZ)
    gy = ((blk // nbz) % nby)[:, None] * BY + (vlin // BZ) % BY
    gz = (blk % nbz)[:, None] * BZ + vlin % BZ
    px, py, pz = _positions(gx + x0, gy, gz, vol.vol_start, vol.voxel)
    code_r = (gx * Y + gy) * Z + gz
    # block-budget overflow counted in voxels
    over_blocks = (n_act - max_blocks).clamp_min(0) * (BX * BY * BZ)
    return dict(px=px, py=py, pz=pz, shell_r=shell_r, code_r=code_r,
                over_blocks=over_blocks, n_rows=row_any.sum())


def _project(px, py, pz, M, m4):
    """s = M p + m4 and the nearest pixel, in float (a float to int cast of
    an out-of-range value is undefined, so the range is tested in float).
    Returns (uf, vf, sz)."""
    M = np.asarray(M, np.float32)
    m4 = np.asarray(m4, np.float32)
    f = float
    sx = f(M[0, 0]) * px + f(M[0, 1]) * py + f(M[0, 2]) * pz + f(m4[0])
    sy = f(M[1, 0]) * px + f(M[1, 1]) * py + f(M[1, 2]) * pz + f(m4[1])
    sz = f(M[2, 0]) * px + f(M[2, 1]) * py + f(M[2, 2]) * pz + f(m4[2])
    safe = torch.where(sz.abs() < 1e-9, torch.full_like(sz, 1e-9), sz)
    return torch.floor(sx / safe + 0.5), torch.floor(sy / safe + 0.5), sz


def _in_image(uf, vf, H: int, W: int):
    return (uf >= 0) & (uf < W) & (vf >= 0) & (vf < H)


def _pixel_index(vis, uf, vf, H: int, W: int):
    """Flat pixel of visible entries, H * W (the dump slot) elsewhere."""
    pix = torch.where(vis, vf * W + uf, torch.full_like(uf, H * W))
    return pix.to(torch.int64)


def _zbuffer(z_s, pix_s, ok_s, codes, H: int, W: int, fill: bool):
    """Packed-key scatter-min over a flat surface list, key-space hole
    fill, decode. z_s f32 (BIG where not ok), pix_s i64 (H * W where not
    ok), codes i64 voxel ids (-1 = empty slot). Returns (zbuf [H*W] f32,
    vid [H*W] i64 with -1 for empty)."""
    n_surface = z_s.shape[0]
    idx_bits = max(int(n_surface - 1).bit_length(), 1)
    z_bits = 31 - idx_bits
    if z_bits < 8:
        raise ValueError(f"surface size {n_surface} leaves {z_bits} z bits")
    z_levels = float(2 ** z_bits)
    zmax = torch.where(z_s < BIG / 2, z_s, torch.zeros_like(z_s)).max()
    z_scale = (z_levels - 1.0) / zmax.clamp_min(1e-3)
    zq = (z_s * z_scale).clamp(0.0, z_levels - 1.0).to(torch.int32)
    idx32 = torch.arange(n_surface, dtype=torch.int32, device=z_s.device)
    key = torch.where(ok_s, (zq << idx_bits) | idx32,
                      torch.full_like(idx32, KEY_EMPTY))
    kbuf = torch.full((H * W + 1,), KEY_EMPTY, dtype=torch.int32,
                      device=z_s.device)
    # the minimum is order-free, so the winner is deterministic
    kbuf.scatter_reduce_(0, pix_s, key, "amin", include_self=True)
    kb = kbuf[:-1]
    if fill:
        # empty pixels take the smallest neighbour key (z-major packing:
        # the nearest-z neighbour); torch.roll wraps at the border as
        # jnp.roll does
        kb2 = kb.view(H, W)
        best = torch.full_like(kb2, KEY_EMPTY)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                best = torch.minimum(best, torch.roll(kb2, (dy, dx), (0, 1)))
        kb = torch.where(kb2 == KEY_EMPTY, best, kb2).reshape(-1)
    have = kb != KEY_EMPTY
    widx = (kb & (2 ** idx_bits - 1)).clamp_max(n_surface - 1).to(torch.int64)
    won = codes[widx]
    vid = torch.where(have & (won >= 0), won, torch.full_like(won, -1))
    zbuf = torch.where(have, (kb >> idx_bits).to(torch.float32) / z_scale,
                       torch.full((), BIG, device=z_s.device))
    return zbuf, vid


def _sort_rows(zkey, cap: int):
    """The ``cap`` smallest of each row, ties in lane order (stable)."""
    z_sd, order = torch.sort(zkey, dim=1, stable=True)
    return z_sd[:, :cap], order[:, :cap]


def _splat_from_rows(rows: dict, M, m4, H: int, W: int, max_blocks: int,
                     max_rows: int, max_surface: int, row_cap: int,
                     fill: bool):
    """Camera-side half of the splat: project the compacted shell rows,
    level-2 compact, packed-key scatter, optional hole fill, decode.
    Returns (zbuf [H*W] f32, vid [H*W] i64 with -1 for empty, overflow,
    clip). ``overflow`` counts hard budget loss (blocks beyond max_blocks,
    rows beyond max_rows, exact-form surface beyond max_surface): the
    z-buffer dropped surface and the budgets should be raised; it feeds the
    fusion step's miss channel. ``clip`` counts the entries a row cap cut,
    each row's farthest; it is reported apart and is not a miss."""
    px, py, pz = rows["px"], rows["py"], rows["pz"]
    shell_r, code_r = rows["shell_r"], rows["code_r"]
    over_blocks, n_rows = rows["over_blocks"], rows["n_rows"]
    L = px.shape[1]

    uf, vf, sz = _project(px, py, pz, M, m4)
    vis_r = shell_r & (sz > 1e-6) & _in_image(uf, vf, H, W)
    pix_r = _pixel_index(vis_r, uf, vf, H, W)
    z_r = torch.where(vis_r, sz, torch.full_like(sz, BIG))

    if row_cap:
        cap = int(min(L, row_cap))
        z_c, order = _sort_rows(z_r, cap)
        ok_s = (z_c < BIG / 2).reshape(-1)
        z_s = z_c.reshape(-1)
        pix_s = torch.where(ok_s, torch.gather(pix_r, 1, order).reshape(-1),
                            torch.full_like(ok_s, H * W, dtype=torch.int64))
        code_s = torch.gather(code_r, 1, order).reshape(-1)
        clip = (vis_r.sum(1) - cap).clamp_min(0).sum()
    else:
        n_all = vis_r.numel()
        sel = _nonzero_fixed(vis_r.reshape(-1), max_surface, n_all)
        ok_s = sel < n_all
        sel_c = sel.clamp_max(n_all - 1)
        z_s = torch.where(ok_s, z_r.reshape(-1)[sel_c],
                          torch.full((), BIG, device=sz.device))
        pix_s = torch.where(ok_s, pix_r.reshape(-1)[sel_c],
                            torch.full_like(sel_c, H * W))
        code_s = code_r.reshape(-1)[sel_c]
        clip = torch.zeros((), dtype=torch.int64, device=sz.device)
        # truncation beyond max_surface drops arbitrary entries: hard loss
        over_blocks = over_blocks + (vis_r.sum() - max_surface).clamp_min(0)
    overflow = over_blocks + (n_rows - max_rows).clamp_min(0) * L
    zbuf, vid = _zbuffer(z_s, pix_s, ok_s, code_s, H, W, fill)
    return zbuf, vid, overflow, clip


def splat_zbuffer(vol: TSDFState, M, m4, H: int, W: int,
                  max_blocks: int = 4096, max_surface: int = 512 * 1024,
                  max_rows: int = 8192, shell_band: float = 0.999,
                  row_cap: int = 0, fill: bool = False):
    """Core splat of a volume from a pinhole: (zbuf, vid, overflow, clip),
    see _splat_from_rows."""
    rows = _compact_shell(vol, max_blocks, max_rows, shell_band)
    return _splat_from_rows(rows, M, m4, H, W, max_blocks, max_rows,
                            max_surface, row_cap, fill)


# ------------------------------------------------------------ candidates

def select_candidates(rows: dict, M, m4, row_cap: int):
    """Camera-side candidate selection: the level-2 sort and cap of
    _splat_from_rows, returning only the selected voxel ids
    ([max_rows * cap] i64, -1 = empty slot) and the (overflow, clip)
    counters. The north-star chunk carries this one array across frames:
    the per-row nearest-``cap`` set drifts little over a few hundredths of
    a radian of camera motion, while each frame's projection is recomputed
    exactly from the ids, so staleness affects only which candidates
    compete, never where they land."""
    px, py, pz = rows["px"], rows["py"], rows["pz"]
    shell_r, code_r = rows["shell_r"], rows["code_r"]
    L = px.shape[1]
    cap = int(min(L, row_cap)) if row_cap else L
    _, _, sz = _project(px, py, pz, M, m4)
    vis_r = shell_r & (sz > 1e-6)       # the in-image test is per frame
    zkey = torch.where(vis_r, sz, torch.full_like(sz, BIG))
    z_c, order = _sort_rows(zkey, cap)
    codes = torch.where(z_c < BIG / 2, torch.gather(code_r, 1, order),
                        torch.full_like(order, -1)).reshape(-1)
    clip = (vis_r.sum(1) - cap).clamp_min(0).sum()
    overflow = rows["over_blocks"] + (rows["n_rows"]
                                      - px.shape[0]).clamp_min(0) * L
    return codes, overflow, clip


def decode_candidates(codes: torch.Tensor, vol: TSDFState):
    """Camera-independent half of splat_from_candidates: candidate ids ->
    world positions (px, py, pz, valid). Invariant between candidate
    refreshes, so the north-star chunk computes it once per refresh."""
    _, Y, Z = vol.diff.shape
    ok0 = codes >= 0
    csafe = codes.clamp_min(0)
    gx = csafe // (Y * Z)
    gy = (csafe // Z) % Y
    gz = csafe % Z
    return (*_positions(gx, gy, gz, vol.vol_start, vol.voxel), ok0)


def splat_from_candidates(codes: torch.Tensor, vol: TSDFState, M, m4,
                          H: int, W: int, fill: bool = True, decoded=None):
    """Render-phase splat over a precomputed candidate set ([N] i64, -1
    empty): decode ids to world positions, project with the current camera,
    packed-key scatter-min, hole fill. ``decoded``: a precomputed
    decode_candidates(...) tuple, for a set that renders several frames.
    Returns (zbuf [H*W], vid [H*W])."""
    if decoded is None:
        decoded = decode_candidates(codes, vol)
    px, py, pz, ok0 = decoded
    uf, vf, sz = _project(px, py, pz, M, m4)
    vis = ok0 & (sz > 1e-6) & _in_image(uf, vf, H, W)
    pix = _pixel_index(vis, uf, vf, H, W)
    z_s = torch.where(vis, sz, torch.full_like(sz, BIG))
    return _zbuffer(z_s, pix, vis, codes, H, W, fill)


# ---------------------------------------------------------------- shading

def _counts(hist: torch.Tensor, vid: torch.Tensor) -> torch.Tensor:
    """Histogram rows of voxel ids as int32 counts. The u16 counts are
    stored in int16 (CUDA has no comparisons on uint16): mask in int32
    before any max or compare."""
    K = hist.shape[-1]
    return hist.view(-1, K)[vid.clamp_min(0)].to(torch.int32) & 0xFFFF


def fetch_shade_inputs(vd2: torch.Tensor, color: torch.Tensor,
                       hist: torch.Tensor, mode: str):
    """Per-pixel shade inputs of a winner-voxel image: (have, bgr, rows)
    with only the channel ``mode`` needs (bgr u8 [H, W, 3] for "color",
    histogram counts i32 [H, W, K] for "instance")."""
    have = vd2 >= 0
    bgr = rows = None
    if mode == "color":
        bgr = color.view(-1, 3)[vd2.clamp_min(0)]
    else:
        rows = _counts(hist, vd2)
    return have, bgr, rows


def shade_fetched(have, bgr, rows, mode: str) -> torch.Tensor:
    """Decode fetched shade inputs to the rendered u8 [H, W, 3] RGB image:
    the volume color (stored BGR, flipped), or the instance palette at the
    histogram's argmax, black for background (bin 0) and for no votes
    (viewer.cu:26-85)."""
    if mode == "color":
        return torch.where(have[..., None], bgr.flip(-1),
                           torch.zeros_like(bgr))
    K = rows.shape[-1]
    obj = torch.argmax(rows, dim=-1)           # first maximum wins ties
    maxc = rows.max(dim=-1).values
    lit = have & (obj > 0) & (maxc > 0)
    with sync("render.palette"):
        pal = torch.from_numpy(INSTANCE_PALETTE[:K]).to(rows.device)
    return torch.where(lit[..., None], pal[obj], torch.zeros_like(pal[:1]))


def _shade(vd2: torch.Tensor, vol: TSDFState, mode: str) -> torch.Tensor:
    """Shade a winner-voxel image [H, W] from the volume's current color or
    histogram."""
    return shade_fetched(*fetch_shade_inputs(vd2, vol.color, vol.hist, mode),
                         mode)


# ----------------------------------------------------------------- probes

def _probe_decode(vid: torch.Tensor, hist: torch.Tensor, thresh: float):
    """Voxel-id image [Hs, Ws] (-1 = none) -> (probs [Hs, Ws, K] raw counts
    f32, box_mask = probs > thresh)."""
    have = vid >= 0
    rows = _counts(hist, vid).float()
    probs = torch.where(have[..., None], rows, torch.zeros_like(rows))
    return probs, probs > thresh


def probe_from_rows(rows: dict, hist: torch.Tensor, extrinsic2init,
                    intrinsic, H: int, W: int, cfg: FusionConfig):
    """Back-projection probe from a precomputed compacted shell. Returns
    (probs, box_mask, overflow, clip)."""
    M, m4 = pinhole_of_extrinsic(extrinsic2init, intrinsic)
    _, vid, overflow, clip = _splat_from_rows(
        rows, M, m4, H, W, cfg.splat_max_blocks, cfg.splat_max_rows,
        cfg.splat_max_surface, cfg.splat_row_cap, fill=True)
    probs, box_mask = _probe_decode(vid.view(H, W), hist, cfg.box_mask_thresh)
    return probs, box_mask, overflow, clip


def splat_probe(vol: TSDFState, extrinsic2init, intrinsic, H: int, W: int,
                cfg: FusionConfig):
    """Back-projection probe (the role of back_proj_kernel,
    tsdf.cu:72-135): per-pixel instance histogram at the fused surface seen
    from the sensor camera, nearest-voxel counts. Returns (probs [H, W, K]
    f32 raw counts, box_mask [H, W, K] bool, overflow, clip)."""
    rows = _compact_shell(vol, cfg.splat_max_blocks, cfg.splat_max_rows,
                          cfg.splat_shell_band)
    return probe_from_rows(rows, vol.hist, extrinsic2init, intrinsic, H, W,
                           cfg)


def depth_probe(vol: TSDFState, depth: torch.Tensor, extrinsic2init,
                intrinsic, cfg: FusionConfig):
    """Per-pixel histogram votes at each depth pixel's voxel. Returns
    (probs [Hs, Ws, K], box_mask [Hs, Ws, K]) at stride cfg.probe_stride;
    pass the equally strided mask to associate_instances. The depth path
    has no budgets, hence no counters."""
    s = cfg.probe_stride
    dev = vol.device
    X, Y, Z = vol.diff.shape

    def f(a):
        with sync("probe.const"):
            return torch.tensor(float(a), dtype=torch.float32, device=dev)

    d_m = depth[::s, ::s].to(dev).to(torch.float32) / f(cfg.depth_scale)
    Hs, Ws = d_m.shape
    Kinv = np.linalg.inv(_host_f32(intrinsic)[:3, :3]).astype(np.float32)
    E = _host_f32(extrinsic2init)
    u = (torch.arange(Ws, dtype=torch.float32, device=dev) * s)[None, :]
    v = (torch.arange(Hs, dtype=torch.float32, device=dev) * s)[:, None]
    # camera-space point at the observed depth: p = d * K^-1 [u, v, 1]
    cx = (f(Kinv[0, 0]) * u + f(Kinv[0, 1]) * v + f(Kinv[0, 2])) * d_m
    cy = (f(Kinv[1, 0]) * u + f(Kinv[1, 1]) * v + f(Kinv[1, 2])) * d_m
    cz = (f(Kinv[2, 2]) + torch.zeros_like(u)) * d_m
    # first-camera frame: p = R^T (c - t)
    R, t = E[:3, :3], E[:3, 3]
    rel = (cx - f(t[0]), cy - f(t[1]), cz - f(t[2]))
    p = [f(R[0, j]) * rel[0] + f(R[1, j]) * rel[1] + f(R[2, j]) * rel[2]
         for j in range(3)]
    g = [torch.round((p[j] - f(vol.vol_start[j])) / f(vol.voxel[j]))
         .to(torch.int64) for j in range(3)]
    ok = ((d_m > 0) & (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y)
          & (g[2] >= 0) & (g[2] < Z))
    lin = ((g[0].clamp(0, X - 1) * Y + g[1].clamp(0, Y - 1)) * Z
           + g[2].clamp(0, Z - 1))
    vid = torch.where(ok, lin, torch.full_like(lin, -1))
    return _probe_decode(vid, vol.hist, cfg.box_mask_thresh)


# ---------------------------------------------------------------- renders

def splat_render(vol: TSDFState, M, m4, H: int, W: int, cfg: FusionConfig,
                 mode: str = "instance", max_blocks: int | None = None,
                 fill: bool = True) -> torch.Tensor:
    """Render the volume from a pinhole (M, m4). Returns uint8 [H, W, 3]
    RGB (instance palette or volume color)."""
    _, vid, _, _ = splat_zbuffer(
        vol, M, m4, H, W, max_blocks or cfg.splat_max_blocks,
        cfg.splat_max_surface, cfg.splat_max_rows, cfg.splat_shell_band,
        cfg.splat_row_cap, fill)
    return _shade(vid.view(H, W), vol, mode)


def splat_render_orbit(vol: TSDFState, angle, dist, intrinsic, H: int,
                       W: int, cfg: FusionConfig, mode: str = "instance",
                       fill: bool = True) -> torch.Tensor:
    """splat_render from the viewer's orbit camera at (angle, dist)."""
    M, m4 = pinhole_of_orbit(angle, dist, intrinsic)
    return splat_render(vol, M, m4, H, W, cfg, mode=mode, fill=fill)


class OrbitRenderer:
    """Viewer-loop renderer. The reference fuses, then orbits the static
    volume (kernel.cpp:101-107), so the state-side shell compaction is
    computed once here and every orbit frame pays only projection, sort,
    scatter and shade.

        orb = OrbitRenderer(vol, intrinsic, H, W, cfg)
        for k in range(n):
            img = orb.render(0.01 * k, dist)
    """

    def __init__(self, vol: TSDFState, intrinsic, H: int, W: int,
                 cfg: FusionConfig, mode: str = "instance"):
        self.vol, self.H, self.W, self.mode, self.cfg = vol, H, W, mode, cfg
        self.intrinsic = _host_f32(intrinsic)
        self.rows = _compact_shell(vol, cfg.splat_max_blocks,
                                   cfg.splat_max_rows, cfg.splat_shell_band)

    def render(self, angle, dist, mode: str | None = None) -> torch.Tensor:
        cfg = self.cfg
        M, m4 = pinhole_of_orbit(angle, dist, self.intrinsic)
        _, vid, _, _ = _splat_from_rows(
            self.rows, M, m4, self.H, self.W, cfg.splat_max_blocks,
            cfg.splat_max_rows, cfg.splat_max_surface, cfg.splat_row_cap,
            fill=True)
        return _shade(vid.view(self.H, self.W), self.vol, mode or self.mode)
