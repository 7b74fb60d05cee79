"""Each driver form at a tiny size on the CPU, the port's plain paths
against the harness's reference: the result line's keys, correct true,
and every compared number at 0. Then the faults the cells can have,
planted in the port underneath a run: correct comes out false."""

import pytest
import torch

from h100bench import run
from h100bench.tests import tiny

CELLS = ("ns512.chunk16", "ns512.step", "ref256.stage2", "ref256.stage1")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_tree(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(root, cell, trace):
    out = run.run(cell, 2 ** 31 + 11, 0.5, bool(trace), root=root,
                  device="cpu")
    want = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(out) == want
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(v["value"] == 0 for v in out["compared"].values()), \
        out["compared"]
    if not trace:
        assert {"frames_per_s", "setup_s"} <= set(out["metrics"])


def _skip_fuse(monkeypatch):
    """A step that leaves the state unchanged: the fuse only counts."""
    from slam_maskrcnn_tpu_torch.fusion import pipeline

    def frame(vol, *a, **k):
        vol.n_obs += 1
        return vol

    def frames2(vol, *a, **k):
        vol.n_obs += 2
        return vol

    monkeypatch.setattr(pipeline, "fuse_frame", frame)
    monkeypatch.setattr(pipeline, "fuse_frames2", frames2)


def _half_batch(monkeypatch):
    """Half of a detect batch left out: its frames get the other half's
    label images."""
    from slam_maskrcnn_tpu_torch.samples import north_star

    orig = north_star.NorthStar.detect_batched

    def half(self, colors, mark=None):
        n = colors.shape[0]
        out = orig(self, colors[:max(n // 2, 1)], mark)
        return torch.cat([out, out])[:n]

    monkeypatch.setattr(north_star.NorthStar, "detect_batched", half)
    orig1 = north_star.NorthStar.detect
    monkeypatch.setattr(north_star.NorthStar, "detect",
                        lambda self, c, mark=None: torch.zeros_like(
                            orig1(self, c, mark)))


def _altered_answer(monkeypatch):
    """An answer altered where it is produced: one pixel of every
    relabeled mask, and of every mask file stage 1 writes."""
    from slam_maskrcnn_tpu_torch.fusion import pipeline
    from slam_maskrcnn_tpu_torch.models import mask_ops

    orig = pipeline.apply_relabel

    def relabel(mask, table):
        out = orig(mask, table).clone()
        out[0, 0] += 1
        return out

    write = mask_ops.write_png

    def write_png(path, img):
        img = img.copy()
        img[0, 0] += 1
        return write(path, img)

    monkeypatch.setattr(pipeline, "apply_relabel", relabel)
    monkeypatch.setattr(mask_ops, "write_png", write_png)


FUSION = ("ns512.chunk16", "ns512.step", "ref256.stage2")
FAULTS = {"state_unchanged": (_skip_fuse, FUSION),
          "half_batch": (_half_batch, ("ns512.chunk16", "ns512.step")),
          "answer_altered": (_altered_answer, CELLS)}


@pytest.mark.parametrize("cell,fault", [(c, f) for f, (_, cs)
                                        in FAULTS.items() for c in cs])
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    FAULTS[fault][0](monkeypatch)
    out = run.run(cell, 2 ** 31 + 12, 0.5, False, root=root, device="cpu")
    assert not out["correct"], out["compared"]
