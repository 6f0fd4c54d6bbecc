"""``sampling_roofline`` (layer: kernels): the real-batch gather's byte
bound as a share of the device time of the sampling kernels in the traced
slice (rank 0's card).

Bytes: ``roofline.sampling_bytes`` of the rows one rank gathers a round
(``modes/<mode>.py:sampled_rows_per_round``) over the slice's rounds.
Kernels: names with "sample" not inside a longer word ("upsample" is
ATen's interpolation, not the gather).
"""

import re

from perfbench import roofline

_SAMPLE = re.compile(r"(?<![a-z])sample", re.IGNORECASE)


def read(r):
    ns = r.device_ns(lambda name: bool(_SAMPLE.search(name)))
    if not ns:
        return None
    rows = r.mode.sampled_rows_per_round(r.traffic) * r.rounds
    nbytes = roofline.sampling_bytes(rows, r.cfg["image_shape"])
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (ns / 1e9)
