"""Frames fully processed in the window over the window's seconds (host
clock; each call ends synchronised, so a frame counts once its call's
work has finished on the device)."""


def read(record):
    return record["frames"] / record["window_s"]
