"""The share of the window in which the device does nothing: one minus
the device's busy seconds a frame in the traced stretch (the union of the
trace's kernel, copy and set intervals, over its frames) against the
window's seconds a frame (host clock, the untraced window of the same
run)."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0 or not record["trace_frames"]:
        return None
    busy = t["busy_s"] / record["trace_frames"]
    return 100.0 * (1.0 - busy / (record["window_s"] / record["frames"]))
