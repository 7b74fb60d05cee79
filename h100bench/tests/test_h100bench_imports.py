"""No module the harness runs imports JAX or the JAX package, compared by
whole top-level name (the port's name, slam_maskrcnn_tpu_torch, begins
with the JAX package's), and the reference imports nothing of the port.
Each check runs in a fresh interpreter whose import system refuses the
names, so an import anywhere underneath fails the run."""

import subprocess
import sys
import textwrap

from h100bench.tests import tiny

BLOCK = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = set(sys.argv[1].split(","))
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[2])
""")


def _python(code: str, blocked: str, tmp_path):
    script = tmp_path / "check.py"
    script.write_text(BLOCK + textwrap.dedent(code))
    return subprocess.run([sys.executable, str(script), blocked, tiny.ROOT,
                           str(tmp_path)], capture_output=True, text=True,
                          timeout=900)


def test_runs_hold_no_jax(tmp_path):
    """run.py, every driver form and metric, the reference and the port's
    modules the drivers use: a tiny run of each cell on the CPU."""
    r = _python("""
        import glob, os, torch
        torch.set_num_threads(2)
        from h100bench import run
        from h100bench.tests import tiny
        root = tiny.make_tree(os.path.join(sys.argv[3], "t"))
        for cell in ("ns512.chunk16", "ns512.step", "ref256.stage2"):
            for trace in (False, True):
                out = run.run(cell, 3, 0.2, trace, root=root, device="cpu")
                assert out["correct"], (cell, out["compared"])
        for p in glob.glob(os.path.join(root, "h100bench", "*", "*.py")):
            run.load_module(p, "m_" + os.path.basename(p).replace(".", "_"))
        held = run.forbidden_modules()
        assert not held, held
        assert "slam_maskrcnn_tpu_torch" in sys.modules
        print("ok")
        """, "jax,jaxlib,flax,slam_maskrcnn_tpu", tmp_path)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_reference_imports_nothing_of_the_port(tmp_path):
    r = _python("""
        import glob, importlib, os
        ref = os.path.join(sys.argv[2], "h100bench", "reference")
        for p in sorted(glob.glob(os.path.join(ref, "*.py"))):
            importlib.import_module("h100bench.reference."
                                    + os.path.basename(p)[:-3])
        for m in ("traffic", "weights", "judge", "counts"):
            importlib.import_module("h100bench." + m)
        print("ok")
        """, "jax,jaxlib,flax,slam_maskrcnn_tpu,slam_maskrcnn_tpu_torch",
        tmp_path)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_forbidden_names_are_whole():
    from h100bench import run

    assert "slam_maskrcnn_tpu" in run.FORBIDDEN
    mods = dict(sys.modules)
    try:
        sys.modules["slam_maskrcnn_tpu_torch_x"] = sys
        sys.modules["jaxlike"] = sys
        assert run.forbidden_modules() == [
            n for n in ("flax", "jax", "jaxlib", "slam_maskrcnn_tpu")
            if n in mods]
    finally:
        sys.modules.pop("slam_maskrcnn_tpu_torch_x")
        sys.modules.pop("jaxlike")
