"""Host milliseconds a frame in ``batch_mask_process``'s "detect" stage
(molding, the Mask R-CNN graph, unmolding and the host label encode; it
ends in a read-back), by the harness's timer passed as ``timer=``, over
the window's calls."""


def read(record):
    s = record["driver"].stage_s("detect", len(record["call_ms"]))
    return None if s is None else 1e3 * s / record["frames"]
