"""Host milliseconds a frame in the port's ``refresh`` (candidate or shell
refresh) and ``render`` (splat and shade) spans, over the traced
stretch."""

from h100bench import spans


def read(record):
    return spans.host_ms(record, ("refresh", "render"))
