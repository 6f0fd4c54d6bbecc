"""``upfirdn2d_ms_per_round`` (layer: kernels): device ms a round (rank 0's
card) in the FIR resampling kernels of the traced slice, whose names hold
"upfirdn2d" (StyleGAN2 config-f's blur and FIR upsampling, forward and
backward).  None where the slice has none (a program without the kernel)."""


def _fir(name):
    return "upfirdn2d" in name


def read(r):
    ns = r.device_ns(_fir)
    if not ns:
        return None
    return ns / 1e6 / r.rounds
