"""The association kernel (csrc/associate.cu) against its plain version
(``claim_plain``) on the card, on the same f32 scores: the seeded frames
and the named cases of ``slam_maskrcnn_tpu_torch.testing.assoc_frames``, at
a small size and at the cells' probe shapes (the depth probe at stride 2 on
480x640: 240x320; the splat probe: 480x640). relabel and num_objs
bit-equal, num_objs chained through both versions; one launch a call through ``associate_instances``,
which syncs nothing (``set_sync_debug_mode("error")``).

Each test takes the ``card`` fixture and skips without a CUDA card. This
file imports no JAX; on the card's machine, which has none, run it without
the suite's conftest:

    python3 -m pytest tests/test_torch_associate_card.py --noconftest -q
"""

import pytest
import torch

from slam_maskrcnn_tpu_torch import kernels
from slam_maskrcnn_tpu_torch.fusion import associate as assoc
from slam_maskrcnn_tpu_torch.fusion.state import FusionConfig
from slam_maskrcnn_tpu_torch.testing import ASSOC_CASES, assoc_frames

torch.set_num_threads(2)

SHAPES = {"small": (48, 64), "depth_probe": (240, 320),
          "splat_probe": (480, 640)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the association kernel runs only "
                    "there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", ASSOC_CASES)
def test_kernel_equals_plain(card, case, shape):
    calls, num_objs, expected = assoc_frames(case, *SHAPES[shape])
    cfg = FusionConfig(vol_dim=(8, 8, 32))
    prior = cfg.prior_mrcnn_err_rate
    n_kernel = n_plain = torch.tensor(num_objs, dtype=torch.int32,
                                      device=card)
    for probs, bm, mask, n_obs in calls:
        args = [torch.from_numpy(a).to(card) for a in (probs, bm, mask)]
        scores = assoc.association_scores(*args, n_obs, cfg)
        r_plain, n_plain = assoc.claim_plain(*scores, n_plain, prior,
                                             mask.size)
        r_claim, n_claim = assoc.claim_cuda(*scores, n_kernel, prior,
                                            mask.size)
        before = kernels.launches.counts["associate"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            r_kernel, n_kernel = assoc.associate_instances(
                *args, n_obs, n_kernel, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert kernels.launches.counts["associate"] == before + 1
        assert r_kernel.dtype == torch.int64 and r_kernel.shape == (32,)
        assert n_kernel.dtype == torch.int32 and n_kernel.shape == ()
        for r, n in ((r_kernel, n_kernel), (r_claim, n_claim)):
            assert torch.equal(r, r_plain), (r.tolist(), r_plain.tolist())
            assert torch.equal(n, n_plain)
    if expected is not None:
        ids, num_after = expected
        assert {m: int(r_kernel[m]) for m in ids} == ids
        assert int(n_kernel) == num_after


@pytest.mark.card
def test_kernel_refuses_more_ids_than_a_block(card):
    K = assoc.MAX_K + 1
    z = torch.zeros(K, device=card)
    with pytest.raises(ValueError, match="at most 1024"):
        assoc.claim_cuda(torch.zeros(K, K, device=card), z > 0, z,
                         z.long(), torch.zeros((), dtype=torch.int32,
                                               device=card), 0.05, 100)
