"""Cross-frame instance association (duplicate merge), on the device.

Port of slam_maskrcnn_tpu/fusion/associate.py (``TSDF::filter_overlaps``,
src/SfM_CUDA/tsdf.cu:304-416). For each current mask id m and global id n:

  score[m][n] = sum over pixels of id m of log(max(probs/n_obs, prior))
              + sum over pixels the volume claims are n (box_mask) but whose
                id is not m of log(max(1 - probs/n_obs, prior))

with the pixel counts alongside; prob = exp(score / count). The best n
per m is accepted iff prob > 3 * prior, claimed greedily 1-1 in ascending
m with best-prob replacement; unmatched ids take fresh global ids in
raster order of first occurrence.

The f32 score (the logs, three products, exp) and the per-id pixel counts
and first pixels are plain PyTorch on either device. What follows them is
only comparisons and integer steps: on a CUDA tensor it is one launch of
``csrc/associate.cu`` with no host sync; on a CPU tensor it is
``claim_plain``, the same steps as K small tensor operations.
"""

from __future__ import annotations

import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.utils.profiling import sync

MAX_K = 1024                 # one thread an id, one block (csrc/associate.cu)


def associate_instances(probs: torch.Tensor, box_mask: torch.Tensor,
                        mask: torch.Tensor, n_obs: int,
                        num_objs: torch.Tensor, cfg: FusionConfig):
    """probs f32 [H, W, K] raw histogram counts; box_mask bool [H, W, K];
    mask [H, W] this frame's label image; n_obs frames fused so far;
    num_objs i32 [] tensor. Returns (relabel i64 [K], new num_objs i32 [])."""
    prob, m_valid, npix, first_idx = association_scores(
        probs, box_mask, mask, n_obs, cfg)
    claim = claim_cuda if prob.is_cuda else claim_plain
    return claim(prob, m_valid, npix, first_idx, num_objs,
                 cfg.prior_mrcnn_err_rate, mask.numel())


def association_scores(probs: torch.Tensor, box_mask: torch.Tensor,
                       mask: torch.Tensor, n_obs: int, cfg: FusionConfig):
    """The f32 part of the association: prob f32 [m, n], m_valid bool [K]
    (the rows that may claim), npix f32 [K] (pixels of each id) and
    first_idx i64 [K] (each id's first pixel in raster order, P if
    absent)."""
    K = cfg.max_objects
    prior = cfg.prior_mrcnn_err_rate
    H, W = mask.shape
    P = H * W
    dev = probs.device

    m_flat = mask.reshape(P).to(torch.int64).clamp(0, K - 1)
    probs_f = probs.reshape(P, K) / max(float(n_obs), 1.0)
    bm = box_mask.reshape(P, K).float()
    logp = torch.log(probs_f.clamp_min(prior))
    logq = torch.log((1.0 - probs_f).clamp_min(prior))

    m_ids = torch.arange(K, device=dev)
    onehot = (m_flat[:, None] == m_ids[None, :]).float()
    npix = onehot.sum(0)
    term1 = onehot.T @ logp                     # [m, n]
    bq = bm * logq
    term2 = bq.sum(0)[None, :] - onehot.T @ bq
    cnt2 = bm.sum(0)[None, :] - onehot.T @ bm

    max_obj_now = m_flat.max() + 1              # tsdf.cu:306-307
    m_valid = (m_ids >= 1) & (m_ids < max_obj_now)
    n_valid = m_ids >= 1
    score = term1 + term2
    cnts = npix[:, None] + cnt2
    prob = torch.where((cnts > 0) & m_valid[:, None] & n_valid[None, :],
                       torch.exp(score / cnts.clamp_min(1.0)),
                       torch.zeros_like(score))
    first_idx = torch.full((K,), P, dtype=torch.int64, device=dev)
    first_idx = first_idx.scatter_reduce(
        0, m_flat, torch.arange(P, device=dev), reduce="amin")
    return prob, m_valid, npix, first_idx


def claim_plain(prob: torch.Tensor, m_valid: torch.Tensor,
                npix: torch.Tensor, first_idx: torch.Tensor,
                num_objs: torch.Tensor, prior: float, P: int):
    """Plain PyTorch version of the association kernel: from
    ``association_scores``' outputs to (relabel i64 [K], new num_objs
    i32 []). K small tensor steps on any device; the CPU's path."""
    K = prob.shape[0]
    dev = prob.device
    m_ids = torch.arange(K, device=dev)
    best_p = prob.max(dim=1).values
    best_n = torch.argmax(prob, dim=1)          # first max wins ties
    accepted = m_valid & (best_p > 3.0 * prior)  # tsdf.cu:349

    # greedy claim in ascending m with best-prob replacement (tsdf.cu:352-364)
    owner = torch.full((K,), -1, dtype=torch.int64, device=dev)
    oprob = torch.zeros(K, dtype=prob.dtype, device=dev)
    for m in range(1, K):
        n = best_n[m:m + 1]
        take = accepted[m] & ((owner[n] < 0) | (oprob[n] < best_p[m]))
        owner = owner.scatter(0, n, torch.where(take, m_ids[m:m + 1],
                                                owner[n]))
        oprob = oprob.scatter(0, n, torch.where(take, best_p[m:m + 1],
                                                oprob[n]))

    eq = owner[None, :] == m_ids[:, None]       # [m, n]
    rev = torch.where(eq.any(dim=1), torch.argmax(eq.int(), dim=1),
                      torch.full_like(m_ids, -1))

    # fresh ids for present-but-unmatched ids, raster order of first pixel
    present = (npix > 0) & (m_ids >= 1)
    needs_new = present & (rev < 0)
    order_key = torch.where(needs_new, first_idx, P + m_ids)
    rank = torch.argsort(torch.argsort(order_key, stable=True), stable=True)
    fresh = num_objs.to(torch.int64) + rank
    new_num_objs = (num_objs + needs_new.sum()).to(torch.int32)
    relabel = torch.where(rev >= 0, rev, torch.where(needs_new, fresh, m_ids))
    with sync("associate.relabel0"):        # a host scalar's upload
        relabel[0] = 0
    return relabel, new_num_objs


def claim_cuda(prob: torch.Tensor, m_valid: torch.Tensor,
               npix: torch.Tensor, first_idx: torch.Tensor,
               num_objs: torch.Tensor, prior: float, P: int):
    """``claim_plain`` as one launch of csrc/associate.cu on prob's CUDA
    device: no host sync, nothing read back."""
    K = prob.shape[0]
    if K > MAX_K:
        raise ValueError(f"association kernel takes at most {MAX_K} ids, "
                         f"got {K}")
    dev = prob.device
    args = (prob, m_valid, npix, first_idx, num_objs.to(dev, torch.int32))
    want = ((torch.float32, K * K), (torch.bool, K), (torch.float32, K),
            (torch.int64, K), (torch.int32, 1))
    if not prob.is_cuda or any(t.dtype != d or t.numel() != n
                               or t.device != dev
                               for t, (d, n) in zip(args, want)):
        raise ValueError("association kernel takes prob f32 [K, K], m_valid "
                         "bool, npix f32, first_idx i64 [K] and num_objs "
                         "i32 [] on one CUDA device")
    prob, m_valid, npix, first_idx, num_objs = (t.contiguous() for t in args)
    relabel = torch.empty(K, dtype=torch.int64, device=dev)
    new_num_objs = torch.empty((), dtype=torch.int32, device=dev)
    fn = kernels.lib("associate").associate_cuda
    kernels.launches.add("associate")
    err = fn(kernels.ptr(prob), kernels.ptr(m_valid), kernels.ptr(npix),
             kernels.ptr(first_idx), kernels.ptr(num_objs),
             float(3.0 * prior), int(P), K, kernels.ptr(relabel),
             kernels.ptr(new_num_objs), kernels.stream_ptr(dev))
    kernels.check(err, "association kernel")
    return relabel, new_num_objs


def apply_relabel(mask: torch.Tensor, relabel: torch.Tensor) -> torch.Tensor:
    """Rewrite mask ids through the relabel table (tsdf.cu:372-389)."""
    K = relabel.shape[0]
    idx = mask.to(torch.int64).clamp(0, K - 1)
    return relabel[idx].to(mask.dtype)
