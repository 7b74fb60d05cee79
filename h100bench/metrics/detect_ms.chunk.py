"""Device milliseconds a frame from a chunk's start to its ``detect``
mark (molding and the batched Mask R-CNN graph), over the window's
calls."""


def read(record):
    ms = record["stage_ms"].get("detect")
    return None if ms is None else ms / record["stage_frames"]
