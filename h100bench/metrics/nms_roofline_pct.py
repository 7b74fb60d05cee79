"""K2 (csrc/nms.cu) against its roofline over the traced stretch: the
least time for the detect runs the trace made (h100bench/counts.py
``k2_bound_s``) over the device time of the NMS kernel in the trace."""

from h100bench import counts


def read(record):
    t = record.get("trace")
    if not t:
        return None
    secs = sum(sum(v) for k, v in t["kernels"].items() if "nms_kernel" in k)
    if secs <= 0:
        return None
    return 100.0 * counts.k2_bound_s(record) / secs
