"""Device milliseconds a frame from a step's start to its ``detect`` mark
(molding and the Mask R-CNN graph at batch 1), over the window's calls."""


def read(record):
    ms = record["stage_ms"].get("detect")
    return None if ms is None else ms / record["stage_frames"]
