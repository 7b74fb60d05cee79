"""Host milliseconds a frame in the port's ``detect`` spans (molding and
the Mask R-CNN graph, its sub-layers included; in stage 1 also the
detections' read-back), over the traced stretch."""

from h100bench import spans


def read(record):
    return spans.host_ms(record, ("detect",))
