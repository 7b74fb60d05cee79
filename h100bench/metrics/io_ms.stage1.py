"""Host milliseconds a frame in ``batch_mask_process``'s "read" (PNG
decode, upload) and "write" (mask PNG encode and write) stages, by the
harness's timer passed as ``timer=``, over the window's calls."""


def read(record):
    n = len(record["call_ms"])
    r = record["driver"].stage_s("read", n)
    if r is None:
        return None
    return 1e3 * (r + (record["driver"].stage_s("write", n) or 0.0)) \
        / record["frames"]
