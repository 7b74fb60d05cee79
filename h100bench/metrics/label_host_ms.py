"""Host milliseconds a frame in the port's ``label`` spans (the device
label encode, ``label_masks_device``; in stage 1 the unmold and the host
label encode), over the traced stretch."""

from h100bench import spans


def read(record):
    return spans.host_ms(record, ("label",))
