"""The whole step's share of the card's dense bf16 peak: the detector's
FLOPs a frame (h100bench/counts.py, from the configuration's shapes,
whatever implements it) times the frames of the window, over the
window's seconds, over 989 TFLOP/s."""

from h100bench import counts


def read(record):
    flops = counts.detector_flops(record["config"]["detector"])
    return (100.0 * flops * record["frames"] / record["window_s"]
            / counts.PEAK_BF16_FLOPS)
