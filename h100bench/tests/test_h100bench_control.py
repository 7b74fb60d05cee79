"""The precision controls: the reference computed one precision below
the configuration's, in the port's place, must come out not correct.
The north-star cells' control (float8 e4m3 for the bfloat16 graph, and
bfloat16 for the float32 TSDF update) and stage 2's (the TSDF update in
bfloat16) at each cell's own size on the card on three seeds; at a tiny
size on the CPU here too."""

import os

import numpy as np
import pytest

from h100bench import northstar, run
from h100bench.tests import tiny

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _load(root, cell):
    w = run.read_json(root, "h100bench", "workloads", cell + ".json")
    return run.read_json(root, "h100bench", "configs",
                         w["config"] + ".json"), w


def _failed(nums: dict) -> list:
    return [k for k, (v, lim) in nums.items() if v > lim]


def _north_star_control(root, cell, seed, dev):
    """The control over the frames a run fuses up to its first judged
    frames: the chunk's warm step and chunk and one judged chunk, or the
    step's warm frames and its judged frames."""
    cfg, w = _load(root, cell)
    if w["driver"] == "chunk":
        n = w["traffic"]["chunk"]
        fused = [np.array([1]), np.arange(2, 2 + n),
                 np.arange(2 + n, 2 + 2 * n)]
        return northstar.control_numbers(cfg, w, seed, dev, fused, True, n,
                                         n)
    n = w["warm_frames"] + w["judge_frames"]
    fused = [np.array([k]) for k in range(1, n + 1)]
    return northstar.control_numbers(cfg, w, seed, dev, fused, False, 1,
                                     w["judge_frames"])


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ("ns512.chunk16", "ns512.step"))
def test_north_star_control_fails(card, cell, seed):
    nums = _north_star_control(tiny.ROOT, cell, seed, card)
    print(cell, seed, nums)
    assert _failed(nums), nums


@pytest.mark.parametrize("cell", ("ns512.chunk16", "ns512.step"))
def test_north_star_control_fails_tiny(tmp_path, cell):
    root = tiny.make_tree(str(tmp_path))
    assert _failed(_north_star_control(root, cell, 5, "cpu"))


def _stage2_control(root, seed, dev, n):
    cfg, w = _load(root, "ref256.stage2")
    mod = run.load_module(os.path.join(root, "h100bench", "drivers",
                                       "stage2.py"), "stage2_driver")
    return mod.control_numbers(cfg, w, seed, dev, n)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_fusion_control_fails(card, seed):
    nums = _stage2_control(tiny.ROOT, seed, card, 32)
    print("ref256.stage2", seed, nums)
    assert _failed(nums), nums


def test_fusion_control_moves_tiny(tmp_path):
    """At the tiny size eight frames of bfloat16 updates move the distance
    (its limit is set for the cell's size, on the card)."""
    root = tiny.make_tree(str(tmp_path))
    assert _stage2_control(root, 5, "cpu", 8)["diff_max_err"][0] > 0


def _stage1_control(root, seed, dev):
    cfg, w = _load(root, "ref256.stage1")
    mod = run.load_module(os.path.join(root, "h100bench", "drivers",
                                       "stage1.py"), "stage1_driver")
    return mod.control_numbers(cfg, w, seed, dev)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_stage1_control_fails(card, seed):
    nums = _stage1_control(tiny.ROOT, seed, card)
    print("ref256.stage1", seed, nums)
    assert _failed(nums), nums


def test_stage1_control_fails_tiny(tmp_path):
    root = tiny.make_tree(str(tmp_path))
    assert _failed(_stage1_control(root, 5, "cpu"))
