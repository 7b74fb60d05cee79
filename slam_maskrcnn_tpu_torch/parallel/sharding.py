"""Several ranks: the volume-sharded fusion step and render, data-parallel
training.

Port of slam_maskrcnn_tpu/parallel/sharding.py on ``torch.distributed``.
Where the JAX package has a device mesh and ``shard_map``, every rank here
is a process holding its own part, and the collectives are explicit. Only
``all_reduce`` (SUM, MIN, MAX) and ``broadcast`` are used: gloo supports
them on CUDA tensors as on CPU ones, so the same code runs

* on the CPU over gloo (the tests),
* as two ranks on one card over gloo (NCCL refuses two ranks on one
  device; ``chip_smoke.py``'s ``sharded`` phase),
* on a machine with several cards over NCCL.

``launch`` spawns the ranks of one program (``torch.multiprocessing``,
a ``file://`` rendezvous in a temporary directory) and returns what each
rank's function returned.

* **Volume sharding.** ``shard_volume_state`` cuts the dense x-major
  ``TSDFState`` into equal x-slabs, one a rank, each a multiple of the
  8-voxel brick (the JAX package shards its blocked state on the block
  axis, which is x-major: the same cut). A slab keeps the whole volume's
  geometry; its x offset is ``rank * slab width``, and the fuse kernel and
  the splat compute every voxel from its global x, by the same expression
  as on one rank. The fuse needs no communication. The association probe
  splats each slab alone, fetches the histogram rows of its own voxels
  (voxel ids are local to a slab), then combines: the nearest surface per
  pixel by MIN, the owning rank by MIN (the lowest wins a tie), and the
  owner's rows by a masked SUM, exact since one rank adds a nonzero row.
  The 1-px hole fill runs after the combine, in z space.
* **The dense step sharded** (backend "xla", the JAX package's
  ``shard_volume_state`` + the same ``fusion_step``): the trilinear
  ray-march probe reads across slab edges, so each rank gets the next
  slab's first plane of diff and of the histogram (``broadcast``) and
  the march runs in rounds, each rank advancing the rays whose samples
  its slab owns, the rays' state summed over the mesh after each round;
  the owner of a hit samples the histogram there. Then
  ``fuse_frame_dense`` on the slab with its x offset. No rank holds more
  than its slab and one plane.
* **Data parallelism.** One step on the global batch, as the JAX package's
  jit over a sharded batch: each rank draws the same global batch and
  keeps its slice (``shard_batch``); each loss is its global numerator
  over its global count (the counts all-reduced before the division), the
  gradients are all-reduced by SUM and clipped as one; with TRAIN_BN the
  batch statistics are the global batch's (``batch_stats_over``: the sums
  and sums of squares all-reduced, Flax's fast variance, not
  ``nn.SyncBatchNorm``'s formula). ``train/trainer.py`` uses these when
  GPU_COUNT > 1.

The JAX ``data_parallel_sharding`` returns jit in/out sharding specs; a
torch program places its tensors itself, so it has no counterpart here.
The sharded step probes with the splat probe whatever ``cfg.probe_mode``
says, as the JAX one does.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from slam_maskrcnn_tpu_torch.device import resolve_device
from slam_maskrcnn_tpu_torch.fusion.associate import (apply_relabel,
                                                      associate_instances)
from slam_maskrcnn_tpu_torch.fusion import raycast
from slam_maskrcnn_tpu_torch.fusion.fuse import fuse_frame, fuse_frame_dense
from slam_maskrcnn_tpu_torch.fusion.splat import (BIG, BX, _compact_shell,
                                                  _counts, _splat_from_rows,
                                                  fetch_shade_inputs,
                                                  pinhole_of_extrinsic,
                                                  pinhole_of_orbit,
                                                  shade_fetched)
from slam_maskrcnn_tpu_torch.fusion.state import TSDFState

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the ranks of the default process group: the
    rank, their number and the device that holds this rank's tensors. A
    mesh of size 1 needs no process group: every collective is then the
    identity."""

    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of this process in the initialized default process group.
    ``n_devices``: the size the caller expects (a ValueError names both
    when they differ). ``device``: this rank's device; by default
    ``cuda:<rank % cards>``, which raises without a card (pass "cpu" to
    run the ranks on the CPU)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or run "
                           "the ranks with parallel.sharding.launch)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks was asked for in a "
                         f"process group of {size}")
    if device is None:
        resolve_device("cuda")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank, size, device)


def single_mesh(device="cuda") -> Mesh:
    """A mesh of one rank, no process group, on ``device`` (the card
    unless the caller asks for the CPU)."""
    return Mesh(0, 1, resolve_device(device))


def all_reduce(t: torch.Tensor, op: str, mesh: Mesh) -> torch.Tensor:
    """``t`` reduced over the mesh by "sum", "min" or "max" (a new tensor;
    ``t`` itself is left as it was)."""
    out = t.clone()
    if mesh.size > 1:
        dist.all_reduce(out, op=_OPS[op])
    return out


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (in place; returned). gloo has no
    16-bit integers: an int16 tensor (the u16 histogram) travels as its
    bytes."""
    if mesh.size > 1:
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.int16 else t,
                       src)
    return t


def _rank_main(rank, fn, world_size, backend, devices, init_file, out_dir,
               threads):
    torch.set_num_threads(threads)
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    try:
        mesh = make_mesh(world_size, devices[rank])
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, backend: str = "gloo", devices=None,
           args: tuple = (), threads: int = 1) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks and return
    each rank's result (whatever ``torch.save`` can write), in rank order.

    ``fn`` must be importable in a fresh interpreter (a module-level
    function). ``devices``: one device a rank; by default rank r on
    ``cuda:<r % cards>``, which raises without a card (pass ["cpu"] *
    world_size for CPU ranks). Two ranks may share one card over gloo.
    Each rank runs with ``threads`` CPU threads. The rendezvous is a file
    in a temporary directory, so concurrent launches do not collide on a
    port. A rank that raises makes ``launch`` raise."""
    import torch.multiprocessing as mp

    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{r % torch.cuda.device_count()}"
                   for r in range(world_size)]
    devices = [str(resolve_device(d)) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    with tempfile.TemporaryDirectory() as tmp:
        # the arguments travel by file: a spawn pipe holds 64 KiB, so
        # larger ones would make each rank's start wait for the previous
        # rank to finish its imports
        torch.save(args, os.path.join(tmp, "args.pt"))
        mp.spawn(_rank_main, args=(fn, world_size, backend, devices,
                                   os.path.join(tmp, "rendezvous"), tmp,
                                   threads),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(world_size)]


# ------------------------------------------------------- data parallelism

def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's slice of a global batch: every array (numpy or tensor)
    cut along its leading axis into ``mesh.size`` equal parts, as tensors
    on the mesh's device."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        B = t.shape[0]
        if B % mesh.size:
            raise ValueError(f"batch entry {k!r} of {B} rows does not split "
                             f"over {mesh.size} ranks")
        b = B // mesh.size
        out[k] = t[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device)
    return out


def shard_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (in place)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast(t.data, mesh)
    return module


def broadcast_seed(mesh: Mesh) -> int:
    """One integer for every rank, drawn by rank 0."""
    seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    t = torch.tensor([seed], dtype=torch.int64, device=mesh.device)
    return int(broadcast(t, mesh)[0])


def reduce_gradients(tensors, mesh: Mesh) -> list:
    """The SUM over the mesh of a list of gradients, in one collective."""
    if mesh.size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([g.reshape(-1) for g in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, i = [], 0
    for g in tensors:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


class _SumOver(torch.autograd.Function):
    """SUM over the mesh with a gradient: the gradient of a rank's input
    is the SUM over the mesh of the gradients of the output (every rank's
    loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce(t, "sum", mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), "sum", ctx.mesh), None


def batch_stats_over(module: torch.nn.Module, mesh: Mesh | None) -> None:
    """Make every training-mode BatchNorm (models/backbone.py) of
    ``module`` take its statistics over the whole mesh's batch: the
    per-channel sums and sums of squares and the element count all-reduced
    by SUM (with a gradient: the backward all-reduces the incoming
    gradient), then Flax's fast variance. A mesh of one, or None, gives
    them back their own batch's statistics. Other modules in the process
    are left as they are."""
    from slam_maskrcnn_tpu_torch.models.backbone import BatchNorm

    reduce_stats = None
    if mesh is not None and mesh.size > 1:
        def reduce_stats(sums: torch.Tensor) -> torch.Tensor:
            return _SumOver.apply(sums, mesh)

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.reduce_stats = reduce_stats


# ------------------------------------------------------ volume sharding

def _slab_width(X: int, n: int) -> int:
    if X % n or (X // n) % BX:
        raise ValueError(f"a volume {X} voxels wide does not split into "
                         f"{n} slabs of whole {BX}-voxel bricks")
    return X // n


def shard_volume_state(state: TSDFState, mesh: Mesh) -> TSDFState:
    """This rank's x-slab of a dense volume: [X / n, Y, Z] of diff, color,
    weight and hist, on the mesh's device, with the whole volume's
    geometry, ``n_obs`` and ``num_objs``. X / n must be a multiple of the
    8-voxel brick."""
    Xl = _slab_width(state.diff.shape[0], mesh.size)
    sl = slice(mesh.rank * Xl, (mesh.rank + 1) * Xl)
    cut = lambda t: t[sl].to(mesh.device).clone()
    return dataclasses.replace(
        state, diff=cut(state.diff), color=cut(state.color),
        weight=cut(state.weight), hist=cut(state.hist),
        num_objs=state.num_objs.to(mesh.device).clone(),
        mv_id=state.mv_id.to(mesh.device), mv_cnt=state.mv_cnt.to(
            mesh.device))


_FIELDS = ("diff", "color", "weight", "hist")


def gather_volume_state(slab: TSDFState, mesh: Mesh,
                        dst: int = 0) -> TSDFState | None:
    """The whole volume on rank ``dst`` (None on the others), from every
    rank's slab: each rank broadcasts its slab in turn."""
    parts = {f: [] for f in _FIELDS}
    for r in range(mesh.size):
        for f in _FIELDS:
            t = getattr(slab, f)
            buf = t.clone() if r == mesh.rank else torch.empty_like(t)
            broadcast(buf, mesh, src=r)
            if mesh.rank == dst:
                parts[f].append(buf)
    if mesh.rank != dst:
        return None
    return dataclasses.replace(
        slab, **{f: torch.cat(parts[f]) for f in _FIELDS})


def _fill_holes_probs(z2d: torch.Tensor, probs: torch.Tensor, big: float):
    """Close 1-px holes of the combined (z, per-pixel rows) images: an
    empty pixel (z >= big) takes the rows of its nearest-z neighbour of 8,
    the first in the scan order on a tie (the JAX package's
    ``_fill_holes_probs``: the splat's key-space fill cannot run before the
    combine, since voxel ids are local to a slab). torch.roll wraps at the
    border as jnp.roll does."""
    empty = z2d >= big
    fz = torch.full_like(z2d, big)
    fp = torch.zeros_like(probs)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nz = torch.roll(z2d, (dy, dx), (0, 1))
            nr = torch.roll(probs, (dy, dx), (0, 1))
            better = empty & (nz < fz)
            fz = torch.where(better, nz, fz)
            fp = torch.where(better[..., None], nr, fp)
    return (torch.where(empty, fz, z2d),
            torch.where(empty[..., None], fp, probs))


def _combine(z2: torch.Tensor, rows: torch.Tensor, mesh: Mesh,
             have: torch.Tensor | None = None):
    """The nearest surface per pixel over the mesh, and its owner's rows:
    (z [H, W], rows [H, W, C]). The lowest rank wins a tie in z; only the
    owner adds its row to the SUM. With ``have`` (the pixels whose inputs
    this rank fetched), the owner adds only those, and the pixels some
    rank added come third (else None)."""
    gz = all_reduce(z2, "min", mesh)
    claim = (z2 <= gz) & (z2 < BIG)
    me = torch.full_like(z2, mesh.rank, dtype=torch.int32)
    owner = all_reduce(torch.where(claim, me, torch.full_like(me, mesh.size)),
                       "min", mesh)
    mine = claim & (owner == mesh.rank)
    owned = None
    if have is not None:
        mine = mine & have
        owned = all_reduce(mine.to(torch.int32), "sum", mesh) > 0
    rows = all_reduce(torch.where(mine[..., None], rows,
                                  torch.zeros_like(rows)), "sum", mesh)
    return gz, rows, owned


def _slab_halo(t: torch.Tensor, mesh: Mesh) -> torch.Tensor | None:
    """The next rank's first x-plane of ``t`` (None on the last rank): each
    rank r > 0 broadcasts its plane 0 in turn, and rank r - 1 keeps it."""
    out = None
    for r in range(1, mesh.size):
        buf = t[0].clone() if mesh.rank == r else torch.empty_like(t[0])
        broadcast(buf, mesh, src=r)
        if mesh.rank == r - 1:
            out = buf
    return out


def _owned(t: torch.Tensor, mine: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's copy of ``t`` where one rank owns each element
    (``mine``, at most one rank true per element): a SUM of the owners'
    bits, 32-bit integers over the wire, so that every value (-0.0
    included) arrives as it left."""
    if mesh.size == 1:
        return t
    bits = t.view(torch.int32) if t.dtype == torch.float32 else t.to(
        torch.int32)
    mine = mine.view(mine.shape + (1,) * (t.dim() - mine.dim()))
    got = all_reduce(torch.where(mine, bits, torch.zeros_like(bits)), "sum",
                     mesh)
    return got.view(torch.float32) if t.dtype == torch.float32 else got.to(
        t.dtype)


_RAY_FIELDS = ("t", "f_t", "step", "t_hit", "alive", "hit", "n")


def sharded_ray_march(slab: TSDFState, o: torch.Tensor, d: torch.Tensor,
                      cfg, mesh: Mesh, halo: torch.Tensor | None):
    """``raycast.ray_march`` of the whole volume, on x-slabs: (hit, t_hit)
    on every rank, bit-equal to one rank's.

    A ray's samples are owned by the slab holding their corner base x
    (``raycast.grid_floor``, clamped to the grid); with the next slab's
    first plane (``halo``, of diff) the owner reads every corner. The
    march runs in rounds: in each, every rank advances the live rays its
    slab owns, one ``raycast.march_update`` an iteration as one rank
    would, until none is left (a ray hit, ran out, left the slab or took
    cfg.max_march_steps steps: a per-ray count stands in for the one-rank
    loop's global one, since every live ray steps once an iteration); the
    rays in flight are a set compacted whenever fewer than half of it are
    still moving, so an iteration costs about what is left of the march.
    Then the state of the rays each rank moved is summed over the mesh.
    A ray's x is monotone in t, so it crosses the slabs in order and the
    rounds are at most the mesh's size."""
    dev = slab.device
    Xl, Y, Z = slab.diff.shape
    dims = (Xl * mesh.size, Y, Z)
    x0 = mesh.rank * Xl
    vs, vx = raycast._t(slab.vol_start, dev), raycast._t(slab.voxel, dev)
    voxel0 = float(slab.voxel[0])
    o = o.to(torch.float32).expand_as(d)
    tnear, tfar = raycast.march_bounds(slab, o, d)

    def mine(p):
        fl, _ = raycast.grid_floor(p, vs, vx, dims)
        return fl[..., 0].clamp(0, dims[0] - 1) // Xl == mesh.rank

    def sample(p):
        return raycast.trilinear(slab.diff, vs, vx, p, x0=x0, dims=dims,
                                 halo=halo)

    t0 = tnear + 1e-6
    p0 = o + t0[..., None] * d
    ray = raycast.march_start(t0, _owned(sample(p0), mine(p0), mesh), tnear,
                              tfar, voxel0)
    ray["n"] = torch.zeros_like(t0, dtype=torch.int32)
    flat = {f: ray[f].view(-1) for f in _RAY_FIELDS}
    of, df, tf = o.reshape(-1, 3), d.reshape(-1, 3), tfar.reshape(-1)
    cap = cfg.max_march_steps
    while bool((flat["alive"] & (flat["n"] < cap)).any()):
        # this rank's live rays, advanced as a set that drops the rays that
        # stopped or left the slab (written back as they are dropped)
        sel = torch.nonzero(flat["alive"] & (flat["n"] < cap)
                            & mine(of + flat["t"][:, None] * df))[:, 0]
        moved = torch.zeros_like(flat["alive"])
        moved[sel] = True
        sub = {f: flat[f][sel] for f in _RAY_FIELDS}
        o_s, d_s, tfar_s = of[sel], df[sel], tf[sel]
        while True:
            p = o_s + sub["t"][:, None] * d_s
            active = sub["alive"] & (sub["n"] < cap) & mine(p)
            left = int(active.sum())          # one sync an iteration
            if 2 * left < sel.numel():
                # drop the stopped rays once fewer than half are left
                keep = torch.nonzero(active)[:, 0]
                for f in _RAY_FIELDS:
                    flat[f][sel] = sub[f]
                sel = sel[keep]
                sub = {f: v[keep] for f, v in sub.items()}
                o_s, d_s, tfar_s, p, active = (
                    o_s[keep], d_s[keep], tfar_s[keep], p[keep],
                    active[keep])
            if not left:
                break
            raycast.march_update(sub, sample(p), active, tfar_s, voxel0)
            sub["n"] = sub["n"] + active.to(torch.int32)
        if mesh.size > 1:
            anyone = all_reduce(moved.to(torch.int32), "sum", mesh) > 0
            for f in _RAY_FIELDS:
                flat[f] = torch.where(anyone, _owned(flat[f], moved, mesh),
                                      flat[f])
    shape = t0.shape
    return flat["hit"].view(shape), flat["t_hit"].view(shape)


def sharded_back_project_probe(slab: TSDFState, extrinsic2init,
                               intrinsic_inv, H: int, W: int, cfg,
                               mesh: Mesh):
    """``raycast.back_project_probe`` of the whole volume on x-slabs:
    (probs [H, W, K], box_mask) on every rank, bit-equal to one rank's.
    One plane of diff and of hist comes from the next rank (the halo);
    the march is ``sharded_ray_march``; the owner of each hit samples the
    histogram there and the rows are summed over the mesh."""
    o, d = raycast.probe_rays(slab, extrinsic2init, intrinsic_inv, H, W)
    hit, t_hit = sharded_ray_march(slab, o, d, cfg, mesh,
                                   _slab_halo(slab.diff, mesh))
    hist_halo = _slab_halo(slab.hist, mesh)
    Xl, Y, Z = slab.diff.shape
    dims = (Xl * mesh.size, Y, Z)
    p = o + t_hit[..., None] * d
    fl, _ = raycast.grid_floor(p, slab.vol_start, slab.voxel, dims)
    mine = hit & (fl[..., 0].clamp(0, dims[0] - 1) // Xl == mesh.rank)
    cnts = raycast.trilinear(slab.hist, slab.vol_start, slab.voxel, p,
                             unsigned=True, x0=mesh.rank * Xl, dims=dims,
                             halo=hist_halo)
    probs = _owned(torch.where(mine[..., None], cnts,
                               torch.zeros_like(cnts)), mine, mesh)
    return probs, probs > cfg.box_mask_thresh


def make_sharded_fusion_step(cfg, mesh: Mesh, max_blocks: int = 4096,
                             max_rows: int = 8192,
                             max_surface: int = 512 * 1024,
                             backend: str = "pallas"):
    """The volume-sharded fusion step. Returns ``step(slab, depth, color,
    mask, e2i, intrinsic) -> (slab, relabeled mask, misses)``, in place on
    this rank's slab (``shard_volume_state``), frame tensors on the mesh's
    device and replicated.

    backend "pallas" (the JAX ``make_sharded_fusion_step``,
    sharding.py:92-214): from the second fused frame on, each rank splats
    its slab from the sensor camera (the splat probe whatever
    ``cfg.probe_mode`` says, as the JAX step: exact form, shell band
    0.999, no row cap, no key-space fill, and per slab the budgets
    ``max_blocks``, ``max_rows``, ``max_surface``, the JAX step's
    defaults) and fetches its voxels' histogram rows; the combine, the
    hole fill and the association follow (module docstring). Then the fuse
    kernel runs on the slab with its x offset. ``misses``: the budget
    overflow summed over the ranks (0-d int64; the fuse itself misses
    nothing).

    backend "xla" (the JAX package's ``shard_volume_state`` and the same
    ``fusion_step`` on the dense state, its histogram at cfg.hist_dtype):
    the trilinear ray-march probe across the slabs
    (``sharded_back_project_probe``), association, relabel and
    ``fuse_frame_dense`` on the slab with its x offset; equal to one
    rank's ``pipeline.fusion_step_dense`` bit for bit. The budgets do not
    apply and ``misses`` is 0 (the march misses nothing). The inverse
    intrinsic is the f32 inverse of ``intrinsic``, as ``SemanticFusion``
    takes it.

    Either way rank 0's relabel table and id count are broadcast, so that
    the ranks cannot drift."""
    if backend not in ("pallas", "xla"):
        raise ValueError(f"backend {backend!r}: 'pallas' or 'xla'")
    if backend == "xla" and cfg.majority_vote:
        raise ValueError("the dense sharded step associates through the "
                         "instance histogram, which majority-vote mode does "
                         "not keep")
    K = cfg.max_objects

    def probe(vol, depth, extrinsic2init, intrinsic):
        H, W = depth.shape
        if backend == "xla":
            Kinv = np.linalg.inv(np.asarray(intrinsic, np.float32)).astype(
                np.float32)
            probs, bm = sharded_back_project_probe(
                vol, extrinsic2init, Kinv, H, W, cfg, mesh)
            return probs, bm, torch.zeros((), dtype=torch.int64,
                                          device=vol.device)
        x0 = mesh.rank * vol.diff.shape[0]
        M, m4 = pinhole_of_extrinsic(extrinsic2init, intrinsic)
        shell = _compact_shell(vol, max_blocks, max_rows, 0.999, x0)
        zbuf, vid, ovf, _ = _splat_from_rows(
            shell, M, m4, H, W, max_blocks, max_rows, max_surface, 0,
            fill=False)
        vd2 = vid.view(H, W)
        rows = torch.where((vd2 >= 0)[..., None],
                           _counts(vol.hist, vd2).float(),
                           torch.zeros((), device=vol.device))
        gz, probs, _ = _combine(zbuf.view(H, W), rows, mesh)
        _, probs = _fill_holes_probs(gz, probs, BIG)
        return probs, probs > cfg.box_mask_thresh, all_reduce(
            ovf.to(torch.int64), "sum", mesh)

    def step(vol: TSDFState, depth, color, mask, extrinsic2init, intrinsic):
        dev = vol.device
        x0 = mesh.rank * vol.diff.shape[0]
        if vol.n_obs > 0:
            probs, bm, misses = probe(vol, depth, extrinsic2init, intrinsic)
            relabel, num_objs = associate_instances(
                probs, bm, mask, vol.n_obs, vol.num_objs, cfg)
            relabel = broadcast(relabel.contiguous(), mesh)
            num_objs = broadcast(num_objs.reshape(1).clone(), mesh)[0]
        else:
            relabel = torch.arange(K, device=dev)
            num_objs = mask.max().to(torch.int32) + 1
            misses = torch.zeros((), dtype=torch.int64, device=dev)
        mask_g = apply_relabel(mask, relabel)
        vol.num_objs = num_objs
        if backend == "xla":
            fuse_frame_dense(vol, depth, color, mask_g, extrinsic2init,
                             intrinsic, cfg, x0=x0)
        else:
            fuse_frame(vol, depth, color, mask_g, extrinsic2init, intrinsic,
                       cfg, x0=x0)
        return vol, mask_g, misses

    return step


def make_sharded_render(cfg, mesh: Mesh, max_blocks: int = 4096,
                        mode: str = "instance"):
    """The volume-sharded splat render (the JAX ``make_sharded_render``,
    sharding.py:219-310), modes "instance" and "color". Returns
    ``render(slab, angle, dist, intrinsic, H, W) -> u8 [H, W, 3]`` RGB, the
    same image on every rank.

    Each rank splats its slab from the orbit camera without the hole fill
    (``max_blocks`` a slab and the config's row budgets) and fetches the
    shade inputs of its own voxels; the combine (nearest z, lowest rank,
    the owner's inputs) and then the hole fill in z space and the shading
    run on every rank. It equals the one-rank ``splat_render_orbit`` but
    where two slabs' surfaces tie at a pixel within the z quantum, or a
    hole is filled from another neighbour (the one-rank fill picks by
    packed key)."""

    def render(vol: TSDFState, angle, dist, intrinsic, H: int, W: int):
        x0 = mesh.rank * vol.diff.shape[0]
        M, m4 = pinhole_of_orbit(angle, dist, intrinsic)
        shell = _compact_shell(vol, max_blocks, cfg.splat_max_rows,
                               cfg.splat_shell_band, x0)
        zbuf, vid, _, _ = _splat_from_rows(
            shell, M, m4, H, W, max_blocks, cfg.splat_max_rows,
            cfg.splat_max_surface, cfg.splat_row_cap, fill=False)
        have, bgr, rows = fetch_shade_inputs(vid.view(H, W), vol.color,
                                             vol.hist, mode)
        inputs = (bgr if mode == "color" else rows).to(torch.int32)
        gz, inputs, owned = _combine(zbuf.view(H, W), inputs, mesh, have)
        gz2, inputs = _fill_holes_probs(
            torch.where(owned, gz, torch.full_like(gz, BIG)), inputs, BIG)
        filled = gz2 < BIG
        if mode == "color":
            return shade_fetched(filled, inputs.to(torch.uint8), None, mode)
        return shade_fetched(filled, None, inputs, mode)

    return render
