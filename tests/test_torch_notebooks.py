"""The port's notebooks (notebooks/torch_{demo,train_shapes,
inspect_weights}.ipynb) executed with nbclient on the CPU (the python3
kernel, cwd notebooks/, a per-cell timeout; any cell error fails), their
printed results held to the JAX package run here on the same inputs:

* demo: the classes detected on shapes scene seed 123 equal the JAX
  model's, the scores within 0.05 (both trunks run in bfloat16, whose
  summation order differs: ROADMAP "Known roundings");
* train_shapes: the two epoch losses finite (TRAIN_BN over one image is
  ill-conditioned, so they are not compared), mAP@50 of the committed
  checkpoint on the 4 val images (seed 1) within 0.02 of the JAX
  ``evaluate_map``;
* inspect_weights: every printed ``display_weight_stats`` row equal to
  the JAX row of the same name (shape, and min / max / mean / std within
  1e-6), and 384 rows on both sides.

Each notebook selects ``DEVICE = "cpu"`` in its first cell."""

import ast
import os

import nbformat
import numpy as np
import pytest
from nbclient import NotebookClient

from slam_maskrcnn_tpu.data.shapes import ShapesDataset
from slam_maskrcnn_tpu.samples.train_shapes import \
    InferenceShapesConfig as JShapes
from slam_maskrcnn_tpu.samples.train_shapes import evaluate_map
from slam_maskrcnn_tpu.viz.visualize import display_weight_stats
from test_torch_detect import _jax_trained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOKS = os.path.join(REPO, "notebooks")
CELL_TIMEOUT = 300


@pytest.fixture(scope="module")
def jax_model():
    return _jax_trained(JShapes)


def _execute(name, monkeypatch) -> list:
    """Run the notebook in a fresh kernel; its cells' printed text."""
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    nb = nbformat.read(os.path.join(NOTEBOOKS, name + ".ipynb"), 4)
    src = "\n".join(c.source for c in nb.cells if c.cell_type == "code")
    assert 'DEVICE = "cpu"' in src and "cuda" not in src.replace(
        '"cuda" runs', "")
    NotebookClient(nb, timeout=CELL_TIMEOUT, kernel_name="python3",
                   resources={"metadata": {"path": NOTEBOOKS}}).execute()
    out = []
    for c in nb.cells:
        out.append("".join(o.get("text", "") for o in c.get("outputs", [])
                           if o.get("output_type") == "stream"))
    return out


def _line(texts, prefix):
    for t in texts:
        for line in t.splitlines():
            if line.startswith(prefix):
                return line[len(prefix):].strip()
    raise AssertionError(f"no line starting {prefix!r}")


def test_demo_notebook(monkeypatch, jax_model):
    texts = _execute("torch_demo", monkeypatch)
    classes = ast.literal_eval(_line(texts, "classes:"))
    scores = np.asarray(_line(texts, "scores:").strip("[]").split(),
                        np.float64)
    ds = ShapesDataset()
    ds.load_shapes(1, 128, 128, seed=123)
    ds.prepare()
    r = jax_model.detect([ds.load_image(0)])[0]
    names = ["BG", "square", "circle", "triangle"]
    assert classes == [names[c] for c in r["class_ids"]]
    np.testing.assert_allclose(scores, np.round(r["scores"], 3), atol=0.05)
    assert "Template-match fallback" in texts[-1]


def test_train_shapes_notebook(monkeypatch, jax_model):
    texts = _execute("torch_train_shapes", monkeypatch)
    losses = ast.literal_eval(_line(texts, "epoch losses:"))
    assert len(losses) == 2 and np.isfinite(losses).all()
    m_ap = float(_line(texts, "mAP@50 ="))
    val = ShapesDataset()
    val.load_shapes(4, 128, 128, seed=1)
    val.prepare()
    want = evaluate_map(jax_model, val, jax_model.config, val.image_ids)
    assert abs(m_ap - want) <= 0.02, (m_ap, want)


def test_inspect_weights_notebook(monkeypatch, jax_model):
    texts = _execute("torch_inspect_weights", monkeypatch)
    assert texts[1].startswith("params loaded")
    rows = [ast.literal_eval(line) for t in texts
            for line in t.splitlines() if line.startswith("{'name'")]
    assert len(rows) == 12 + 8
    want = {r["name"]: r for r in display_weight_stats(jax_model)}
    assert f"{len(want)} weight tensors" in "".join(texts)
    for row in rows:
        j = want[row["name"]]
        assert tuple(row["shape"]) == tuple(j["shape"]), row["name"]
        for k in ("min", "max", "mean", "std"):
            assert abs(row[k] - float(j[k])) <= 1e-6, (row["name"], k)
