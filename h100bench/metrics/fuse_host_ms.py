"""Host milliseconds a frame in the port's ``fuse`` spans (the K1 and
K1-pair wrappers: their host constants and the launch), over the traced
stretch."""

from h100bench import spans


def read(record):
    return spans.host_ms(record, ("fuse",))
