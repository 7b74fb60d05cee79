"""Cross-frame instance association (duplicate merge), on the device.

Port of slam_maskrcnn_tpu/fusion/associate.py (``TSDF::filter_overlaps``,
src/SfM_CUDA/tsdf.cu:304-416). For each current mask id m and global id n:

  score[m][n] = sum over pixels of id m of log(max(probs/n_obs, prior))
              + sum over pixels the volume claims are n (box_mask) but whose
                id is not m of log(max(1 - probs/n_obs, prior))

with the pixel counts alongside; prob = exp(score / count). The best n
per m is accepted iff prob > 3 * prior, claimed greedily 1-1 in ascending
m with best-prob replacement; unmatched ids take fresh global ids in
raster order of first occurrence. Everything stays on the device: the
claim loop is K small tensor steps with no host sync.
"""

from __future__ import annotations

import torch

from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig


def associate_instances(probs: torch.Tensor, box_mask: torch.Tensor,
                        mask: torch.Tensor, n_obs: int,
                        num_objs: torch.Tensor, cfg: FusionConfig):
    """probs f32 [H, W, K] raw histogram counts; box_mask bool [H, W, K];
    mask [H, W] this frame's label image; n_obs frames fused so far;
    num_objs i32 [] tensor. Returns (relabel i64 [K], new num_objs i32 [])."""
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
    first_idx = torch.full((K,), P, dtype=torch.int64, device=dev)
    first_idx = first_idx.scatter_reduce(
        0, m_flat, torch.arange(P, device=dev), reduce="amin")
    present = (npix > 0) & (m_ids >= 1)
    needs_new = present & (rev < 0)
    order_key = torch.where(needs_new, first_idx, P + m_ids)
    rank = torch.argsort(torch.argsort(order_key, stable=True), stable=True)
    fresh = num_objs.to(torch.int64) + rank
    new_num_objs = (num_objs + needs_new.sum()).to(torch.int32)
    relabel = torch.where(rev >= 0, rev, torch.where(needs_new, fresh, m_ids))
    relabel[0] = 0
    return relabel, new_num_objs


def apply_relabel(mask: torch.Tensor, relabel: torch.Tensor) -> torch.Tensor:
    """Rewrite mask ids through the relabel table (tsdf.cu:372-389)."""
    K = relabel.shape[0]
    idx = mask.to(torch.int64).clamp(0, K - 1)
    return relabel[idx].to(mask.dtype)
