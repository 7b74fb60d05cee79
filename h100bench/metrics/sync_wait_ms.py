"""Host milliseconds a frame inside the port's ``sync:*`` spans (the host
read-backs and blocking uploads, each waiting for the device), over the
traced stretch."""

from h100bench import spans


def read(record):
    return spans.host_ms(record, prefix="sync:")
