"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/kernels/<name>-<hash>.so`` at the repository root (a plain C
interface, loaded with ``ctypes``); the hash covers the source, the flags
and the shared headers ``csrc/*.cuh``. All sources are compiled in parallel
on first use; a library whose source and flags are unchanged is reused.
Nothing here runs when the package is imported: the CPU tests import
every module on a machine without ``nvcc``. ``host_library`` builds the
host C++ sources (``csrc/*.cpp``: the RLE core, the JPEG entropy coder)
with g++ the same way.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``--fmad=false`` — no multiply-add
contraction, so each kernel rounds exactly like its plain PyTorch version
(see csrc/fuse.cu).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("fuse", "nms", "nms_sorted", "roi_align")
# the kernels that have a wrapper and a launch count of their own
# (csrc/fuse.cu holds two)
KERNELS = ("fuse", "fuse_pair", "nms", "nms_sorted", "roi_align")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each library's entry points (pointers and the stream
# as c_void_p: a bare Python int would be cut to 32 bits)
_SIGNATURES = {
    "fuse": {"fuse_frame_cuda": [_P, _P, _P, _P, _I, _I, _I, _I,
                                 _P, _P, _P, _I, _I, _P, _P, _P, _I, _P],
             "fuse_frames2_cuda": [_P, _P, _P, _P, _I, _I, _I, _I,
                                   _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _P, _P, _P]},
    "nms": {"nms_cuda": [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P]},
    "nms_sorted": {"nms_sorted_cuda": [_P, _I, _I, _F, _P, _P, _P],
                   "nms_sorted_pairs_cuda": [_P, _I, _I, _F, _P, _P],
                   "nms_sorted_scan_cuda": [_I, _I, _P, _P, _P]},
    "roi_align": {"roi_align_cuda": [_I, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _F, _P, _P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def _target(name: str) -> str:
    """The library's path, named by a hash of its source, the flags and
    every header under csrc/ (a source may include any of them)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build_all(logs: dict | None = None) -> dict[str, str]:
    """Compile every source that has no up-to-date library, one nvcc per
    source, all started together. Returns {name: library path}. With a
    ``logs`` dict, nvcc runs with -Xptxas=-v (registers, spills and shared
    memory of every kernel) and its output is stored there by source."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in SOURCES}
    procs = {}
    for name, out in targets.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        if logs is not None:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        if logs is not None:
            logs[name] = log
        os.replace(tmp, out)  # atomic: a concurrent build never sees a part
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources first if
    needed."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, path in paths.items():
                dll = ctypes.CDLL(path)
                for fn_name, argtypes in _SIGNATURES[n].items():
                    fn = getattr(dll, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _libs[n] = dll
        return _libs[name]


def host_library_path(name: str, flags, build_dir: str = BUILD_DIR) -> str:
    """Where csrc/<name>.cpp's host library goes, named by a hash of the
    source and the g++ flags."""
    h = hashlib.sha1(" ".join(flags).encode())
    with open(os.path.join(CSRC, name + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"{name}-{h.hexdigest()[:12]}.so")


def host_library(name: str, flags, build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """csrc/<name>.cpp, a host library (not a kernel), built by g++ on
    first use and loaded with ctypes. There is no fallback: a failed
    build raises."""
    so = host_library_path(name, flags, build_dir)
    if not os.path.exists(so):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: csrc/{name}.cpp is built "
                               f"with it")
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [gxx, *flags, "-o", tmp, os.path.join(CSRC, name + ".cpp")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on csrc/{name}.cpp:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class LaunchCounter:
    """Launch counts of every kernel wrapper. A wrapper adds one where it
    launches its kernel and nowhere else."""

    def __init__(self):
        self.counts = {n: 0 for n in KERNELS}

    def add(self, name: str) -> None:
        self.counts[name] += 1

    def reset(self) -> None:
        for n in self.counts:
            self.counts[n] = 0


launches = LaunchCounter()
