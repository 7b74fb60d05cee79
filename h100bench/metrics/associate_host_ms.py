"""Host milliseconds a frame in the port's ``probe``, ``associate`` and
``relabel`` spans (the depth or splat probe, Bayesian association and the
relabel), over the traced stretch."""

from h100bench import spans


def read(record):
    return spans.host_ms(record, ("probe", "associate", "relabel"))
