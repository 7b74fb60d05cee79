"""The batch-1 inference trunk as one CUDA graph per input shape.

At batch 1 the trunk (molded images -> ResNet -> FPN -> the shared RPN
head over P2-P6, ``MaskRCNNModule._trunk``) issues about 1,350 small
kernels, and the host's issue of them, not the card's work, sets the pace
of a frame. ``TrunkGraph`` captures that span once per input shape as a
CUDA graph and replays it: the same kernels on the same bits, in one
launch. The span holds no sync, no hand kernel and no data-dependent
shape.

``MaskRCNNModule._forward`` asks for a replay only where the module can
observe that one is sound and pays: the images on CUDA, a batch of 1, the
module in eval mode, grad off. At a larger batch the trunk's launches are
shared by the batch's frames, and the graph would keep the whole batch's
static pyramid alive between calls; training needs autograd.

The cache lives on the module, so dropping the module frees the graphs'
memory pools. A graph is kept per input shape, dtype and device, module
dtype and TF32 flags, and remembers the ``data_ptr`` of every parameter
and buffer the trunk reads: weights written in place are what the next
replay reads, and replaced ones (``.to()``, a new ``nn.Parameter``,
``load_state_dict(assign=True)``) make the next call capture again in the
old graph's place. A forward hook on a trunk module (models/inspect.py)
sends the call down the eager path, since a replay would not call it.

The counters ``graph.trunk.capture`` and ``graph.trunk.replay``
(utils/profiling.py ``count``, always on) say how often each happens.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn.modules import module as nn_module

from slam_maskrcnn_tpu_torch.utils.profiling import count

WARMUP = 3          # eager passes on a side stream before a capture


class Captured(NamedTuple):
    """One captured trunk: ``graph.replay()`` reads ``static_in`` and
    writes ``outputs``; ``ptrs`` are the weights' addresses it reads."""

    graph: object
    static_in: torch.Tensor
    outputs: tuple
    ptrs: tuple


def weight_ptrs(modules) -> tuple | None:
    """The ``data_ptr`` of every parameter and buffer of ``modules`` and
    their submodules, in a fixed order; None if a forward hook is set on
    one of them (or globally). Read every frame: a few hundred
    microseconds for ResNet-101's trunk."""
    if nn_module._global_forward_hooks or \
            nn_module._global_forward_pre_hooks:
        return None
    tensors = []
    stack = list(modules)
    while stack:
        m = stack.pop()
        if m._forward_hooks or m._forward_pre_hooks:
            return None
        tensors += m._parameters.values()
        tensors += m._buffers.values()
        stack += m._modules.values()
    return tuple(map(torch.Tensor.data_ptr, tensors))


class TrunkGraph:
    """The captured trunks of one ``MaskRCNNModule``."""

    DEVICES = ("cuda",)         # where a capture can be made

    def __init__(self):
        self._graphs: dict = {}

    def replay(self, module, images):
        """``module._trunk(images)`` (P2..P6, RPN probs, RPN deltas) from
        the graph of the images' shape, captured first where there is none
        or the trunk's weights moved; None where a hook is set on a trunk
        module. The outputs are the graph's static tensors: the next
        replay overwrites them."""
        ptrs = weight_ptrs((module.resnet, module.fpn, module.rpn_model))
        if ptrs is None:
            return None
        key = (tuple(images.shape), images.dtype, images.device,
               module.dtype, torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        entry = self._graphs.get(key)
        if entry is not None and entry.ptrs != ptrs:
            del self._graphs[key]       # its pool goes before the capture
            entry = None
        if entry is None:
            entry = self._graphs[key] = self.capture(module._trunk, images,
                                                     ptrs)
            count("graph.trunk.capture")
        entry.static_in.copy_(images)
        entry.graph.replay()            # on its capture's device
        count("graph.trunk.replay")
        return entry.outputs

    @staticmethod
    def capture(fn, images, ptrs) -> Captured:
        """``fn`` on a static copy of ``images`` captured as a CUDA graph,
        after ``WARMUP`` eager passes on a side stream (cuDNN's algorithm
        choice and every lazy initialisation happen there)."""
        with torch.cuda.device(images.device):
            static_in = images.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(static_in)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = fn(static_in)
        return Captured(graph, static_in, outputs, ptrs)
