"""K1 (csrc/fuse.cu, single and paired) against its roofline over the
traced stretch: the least time the card could take for the frames the
trace fused (h100bench/counts.py ``k1_bound_s``) over the device time of
the fuse kernels and their depth-tile pass in the trace."""

from h100bench import counts

KERNELS = ("fuse_kernel", "fuse_pair_kernel", "depth_tiles_kernel")


def read(record):
    t = record.get("trace")
    if not t:
        return None
    secs = sum(sum(v) for k, v in t["kernels"].items()
               if any(n in k for n in KERNELS))
    if secs <= 0:
        return None
    return 100.0 * counts.k1_bound_s(record) / secs
