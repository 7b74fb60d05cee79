"""counts.py against hand counts at tiny shapes: the detector's FLOPs
against a count taken from the reference graph's own layers as they run,
K2's bytes and operations by hand, K1's valid and gated voxels against
the reference fuse's own updates."""

import pytest
import torch

from h100bench import counts, northstar, traffic, weights
from h100bench.reference import fuse as ref_fuse
from h100bench.reference.backbone import Conv
from h100bench.reference.heads import ConvTranspose, Dense
from h100bench.run import read_json
from h100bench.tests import tiny


@pytest.fixture(scope="module")
def cfg():
    c = tiny.shrink_config(read_json(tiny.BENCH, "configs",
                                     "north_star_r101_512.json"))
    c["detector"]["COMPUTE_DTYPE"] = "float32"
    return c


@pytest.mark.parametrize("backbone", ("resnet50", "resnet101"))
def test_detector_flops_match_the_graph(cfg, backbone):
    det = dict(cfg["detector"], BACKBONE=backbone)
    m = weights.reference_module(det, "cpu")
    weights.draw(m, 0, cfg["weights"])
    seen = []

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, Conv):
            k, cin = mod.kernel, mod.weight.shape[1]
            n = out.shape[0] * out.shape[2] * out.shape[3]
            seen.append(2 * k * k * cin * out.shape[1] * n)
        elif isinstance(mod, Dense):
            seen.append(2 * x.shape[0] * mod.weight.numel())
        elif isinstance(mod, ConvTranspose):
            seen.append(2 * x.shape[0] * x.shape[2] * x.shape[3]
                        * mod.weight.numel())

    for mod in m.modules():
        if isinstance(mod, (Conv, Dense, ConvTranspose)):
            mod.register_forward_hook(hook)
    H, W = det["IMAGE_SHAPE"][:2]
    from h100bench.reference.anchors import get_anchors
    import types
    anchors = torch.from_numpy(get_anchors(types.SimpleNamespace(
        **{k: v for k, v in det.items()}), (H, W)))
    m(torch.zeros(1, H, W, 3), anchors, torch.tensor([[0., 0., 1., 1.]]))
    assert sum(seen) == counts.detector_flops(det)


def test_k2_launch_by_hand():
    assert counts.k2_launch(2, 6000, 1000) == (2 * (6000 * 20 + 1000 * 5),
                                               2 * 1001 * 6000 * 12)
    assert counts.bound_s(3.35e12, 0) == 1.0
    assert counts.bound_s(0, 67e12) == 1.0


def test_k1_masks_match_the_fuse(cfg):
    cell = tiny.shrink_cell(read_json(tiny.BENCH, "workloads",
                                      "ns512.step.json"))
    seq = traffic.sequence(cell["traffic"], cfg["camera"], 7, "cpu")
    ref = northstar.reference_runner(cfg, cell, 7, "cpu")
    state = ref_fuse.init_from_first_frame(
        ref.cfg, seq.depth[0].numpy(), ref.intrinsic, seq.mean_depth,
        device="cpu")
    geo = dict(vol_start=state.vol_start, voxel=state.voxel,
               mu=float(state.mu))
    k = 3
    w0, h0 = state.weight.clone(), state.hist.clone()
    ref_fuse.fuse_frame(state, seq.depth[k], seq.color[k], seq.mask[k],
                        seq.e2i[k], ref.intrinsic, ref.cfg)
    dims = cfg["fusion"]["vol_dim"]
    v, g = counts.k1_masks(geo, dims, cfg["fusion"], ref.intrinsic,
                           seq.depth[k], seq.e2i[k], 0, dims[0])
    assert int(v.sum()) > 0
    assert torch.equal(v, state.weight != w0)
    assert torch.equal(g, (state.hist != h0).any(-1))
