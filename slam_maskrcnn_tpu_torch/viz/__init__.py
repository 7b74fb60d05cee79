"""Viewer of the fused volume; detection composites and captions."""
from slam_maskrcnn_tpu_torch.viz.visualize import (apply_mask,
                                                   display_instances,
                                                   draw_boxes, random_colors)
from slam_maskrcnn_tpu_torch.viz.viewer import Viewer
