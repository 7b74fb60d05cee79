"""The port's host syncs a frame: its ``sync.*`` counters (one a host
read-back or blocking upload it passed), over the traced stretch."""

from h100bench import spans


def read(record):
    return spans.counted(record, "sync.")
