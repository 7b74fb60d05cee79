"""Two-view structure from motion and PatchMatch stereo (sfm/)."""

from slam_maskrcnn_tpu_torch.sfm.patchmatch import PatchMatch
from slam_maskrcnn_tpu_torch.sfm.two_view import (estimate_rt_from_e,
                                                  match_features,
                                                  slam_two_view, triangulate)

__all__ = ["PatchMatch", "estimate_rt_from_e", "match_features",
           "slam_two_view", "triangulate"]
