"""``collective_ms_per_round`` (layer: ranks): device ms a round in NCCL
kernels on rank 0's card (the cotangent's all-reduce and the chunk's
gathers of the losses).  0 where the slice has device work and none."""


def read(r):
    if not r.summary["launches"]:
        return None
    return r.device_ns(lambda name: "nccl" in name.lower()) / 1e6 / r.rounds
