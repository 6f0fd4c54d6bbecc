"""Faults planted in the program for the fault tests: each is a hook that
every rank of a run calls before its set-up (``harness.drive``)."""


def unchanged():
    """A step that returns its state unchanged: Adam updates nothing."""
    from mdgan_tpu_torch.engine import state

    state.NetState.adam_step = lambda self, cfg: None


def half_batch():
    """Half of each real batch left out, the mean taken over the rest."""
    from mdgan_tpu_torch.ops import losses

    d_loss = losses.d_loss
    losses.d_loss = lambda real, fake, total=None: d_loss(real[:real.shape[0] // 2], fake, total)


def loss_altered():
    """The discriminator loss altered where it is produced: its real term
    alone."""
    from mdgan_tpu_torch.ops import losses

    losses.d_loss = lambda real, fake, total=None: losses.bce_real(real, total)


def gather_shift():
    """The chunk's gather reads the wrong round: every round of a sampling
    launch gets its first round's rows."""
    from mdgan_tpu_torch.engine import mdgan

    sample = mdgan.sample_normalize
    mdgan.sample_normalize = lambda data, idx: sample(data, idx[:1].expand_as(idx).contiguous())


def no_exchange():
    """The exchange between chips left out: each rank's cotangent stays its
    own."""
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    MDGANEngine._sum_over_workers = lambda self, cot, fb_sq: (cot, fb_sq)
