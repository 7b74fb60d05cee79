"""Detection parity in float32, port vs JAX, on scenes 10-19 of the 20
committed parity scenes (the 96^2, 192^2 and stretched 64x384 ones):
the second half of tests/test_torch_detect.py's check, in a file of its
own to keep each file's time down. Bars as there."""

import torch

from test_torch_detect import f32_parity

# the suite runs several workers on few cores: keep torch's thread pool
# small, or its spinning threads starve one another
torch.set_num_threads(2)


def test_f32_detect_matches_jax_second_half():
    f32_parity(10, 20)
