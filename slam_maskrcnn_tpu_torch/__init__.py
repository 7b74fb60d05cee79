"""PyTorch + CUDA port of slam_maskrcnn_tpu for NVIDIA Hopper.

Mask R-CNN detection feeding semantic TSDF fusion, with the TPU's Pallas
kernels rewritten as CUDA kernels (``csrc/``). The JAX package
``slam_maskrcnn_tpu`` stays the reference; module names here mirror it.

Every entry point runs on ``device="cuda"`` unless the caller asks for
``device="cpu"``, where each kernel wrapper uses its plain PyTorch
version.
"""

from slam_maskrcnn_tpu_torch.device import resolve_device  # noqa: F401
