"""Host milliseconds a frame in the port's ``upload`` spans
(``parse_frame``'s copies of the host frame to the device), over the
traced stretch."""

from h100bench import spans


def read(record):
    return spans.host_ms(record, ("upload",))
