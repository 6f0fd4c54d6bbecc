"""InceptionV3 feature network in PyTorch (for FID / Inception Score).

Port of ``mdgan_tpu/metrics/inception.py:1-40, 52-215`` as an NCHW
``nn.Module`` with torchvision's module and state-dict names, in the same
two graph variants:

  * ``fid_variant=False``: torchvision's ``inception_v3`` graph, branch
    avg-pools with ``count_include_pad=True``, 1000 classes;
  * ``fid_variant=True``: the FID-Inception graph (pytorch-fid /
    torch-fidelity "inception-v3-compat"): ``count_include_pad=False``, a
    MAX pool in ``Mixed_7c``'s pool branch, 1008 classes.

BatchNorm is frozen (eps 1e-3, running statistics) at inference.
:func:`calibrated_stats` is the port of ``calibrated_variables``
(``:356-403``): one pass with momentum 0 over at most the first 64 images
writes each layer's batch statistics (flax's biased ``E[x^2] - E[x]^2``)
into the frozen ones, for the random-init network.

Weights: a converted torchvision or pytorch-fid state dict
(``cli/convert_inception.py``) at ``data/inception_v3.npz`` or
``inception_v3.npz`` loads with ``load_state_dict``; without one, a
deterministic random init from a seeded ``torch.Generator`` is used and
:func:`feature_source` says ``"random-init"``.  Random-init FIDs of the port
and of the JAX package come from different random networks and cannot be
compared with each other; within one package they are reproducible.

Preprocessing (``_run_fn``, ``:428-434``): channel-repeat for grayscale,
bilinear resize to 299x299 with ``align_corners=False``, then ``x*2-1``.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_CALIBRATION_CAP = 64
_INIT_SEED = 42


class FrozenBN(nn.Module):
    """BatchNorm with frozen statistics (torchvision's state-dict names,
    without ``num_batches_tracked``).  With ``calibrating`` set, a forward
    first writes the batch's statistics (flax's fast variance) into the
    running ones: momentum 0."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.calibrating = False
        self.weight = nn.Parameter(torch.ones(num_features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(num_features), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.calibrating:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BasicConv(nn.Module):
    """conv (no bias) + frozen BN (eps 1e-3) + relu (``inception.py:52-72``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = FrozenBN(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, fid_variant: bool = False):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x, not self.fid_variant))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int, fid_variant: bool = False):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avgpool3(x, not self.fid_variant))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``max_branch_pool``: the FID-compat graph's Mixed_7c pools its pool
    branch with a MAX pool (``inception.py:152-157``)."""

    def __init__(self, in_ch: int, fid_variant: bool = False, max_branch_pool: bool = False):
        super().__init__()
        self.fid_variant = fid_variant
        self.max_branch_pool = max_branch_pool
        self.branch1x1 = BasicConv(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.max_branch_pool:
            pooled = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            pooled = _avgpool3(x, not self.fid_variant)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3(nn.Module):
    """(b, 3, 299, 299) in [-1, 1] -> (pool features (b, 2048), logits)."""

    def __init__(self, num_classes: int = 1000, fid_variant: bool = False):
        super().__init__()
        fid = fid_variant
        self.fid_variant = fid_variant
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, fid)
        self.Mixed_7c = InceptionE(2048, fid, max_branch_pool=fid)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        feats = x.mean(dim=(2, 3))
        return feats, self.fc(feats)


@torch.no_grad()
def random_init_(model: nn.Module, seed: int = _INIT_SEED) -> nn.Module:
    """Deterministic random weights from a seeded ``torch.Generator`` (drawn
    on the CPU, so every device gets the same network): conv and fc weights
    ~ N(0, 1/fan_in), biases 0, BN scale 1 and shift 0, statistics 0 / 1."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / fan_in ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# the process's network, per device
# ---------------------------------------------------------------------------

_CACHED: Dict[str, Tuple[InceptionV3, str, Dict[str, torch.Tensor]]] = {}
_LOCK = threading.RLock()  # the frozen statistics are swapped per tracker
_CALIB_CACHE: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}


def _stat_names(model: nn.Module):
    return [k for k, _ in model.named_buffers()]


def get_inception(weights_path: Optional[str] = None, device="cpu"):
    """(model, source) on ``device``, cached per device.  The graph variant
    follows the weights: a 1008-way ``fc`` is the FID-compat graph
    (``inception.py:295-336``)."""
    device = torch.device(device)
    key = str(device)
    with _LOCK:
        if key in _CACHED and weights_path is None:
            return _CACHED[key][0], _CACHED[key][1]
        candidates = [weights_path] if weights_path else []
        candidates += ["data/inception_v3.npz", "inception_v3.npz"]
        found = next((Path(c) for c in candidates if c and Path(c).exists()), None)
        if found is not None:
            with np.load(found) as npz:
                flat = {k: torch.from_numpy(np.asarray(npz[k], np.float32)) for k in npz.files}
            if "fc.bias" not in flat:
                raise KeyError(f"{found}: missing 'fc.bias' — not an InceptionV3 "
                               "state-dict npz (expected the cli.convert_inception layout)")
            n_classes = int(flat["fc.bias"].shape[0])
            model = InceptionV3(num_classes=n_classes, fid_variant=n_classes == 1008)
            model.load_state_dict(flat)
            source = ("pretrained:fid-compat" if n_classes == 1008
                      else "pretrained:torchvision")
        else:
            model = random_init_(InceptionV3())
            source = "random-init"
        model = model.to(device).eval().requires_grad_(False)
        base = {k: v.clone() for k, v in model.named_buffers()}
        _CACHED[key] = (model, source, base)
        for k in [k for k in _CALIB_CACHE if k[0] == key]:
            del _CALIB_CACHE[k]
        return model, source


def feature_source(device="cpu") -> str:
    """``'random-init'``, ``'pretrained:torchvision'`` or
    ``'pretrained:fid-compat'``."""
    return get_inception(device=device)[1]


def feature_source_if_loaded() -> Optional[str]:
    """:func:`feature_source` without building the network: None when no
    FID/IS ran in this process."""
    with _LOCK:
        return next(iter(_CACHED.values()))[1] if _CACHED else None


def _to_input(images01, device) -> torch.Tensor:
    """(n, H, W, C) images in [0, 1] -> (n, 3, 299, 299) in [-1, 1]."""
    x = torch.as_tensor(np.asarray(images01, np.float32) if not torch.is_tensor(images01)
                        else images01, dtype=torch.float32).to(device)
    x = x.permute(0, 3, 1, 2)
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
    return x * 2.0 - 1.0


def _calibration_key(x: np.ndarray) -> str:
    h = hashlib.sha1(x.tobytes())
    h.update(repr((x.shape, str(x.dtype))).encode())
    return h.hexdigest()


@torch.no_grad()
def calibrated_stats(images01, device="cpu") -> Dict[str, torch.Tensor]:
    """Frozen BN statistics calibrated on ``images01`` (at most the first 64,
    in order), the port of ``calibrated_variables`` (``inception.py:356-403``):
    one pass with momentum 0.  Pure in (base weights, images) and cached by
    content; the base statistics unchanged for pretrained weights."""
    model, source = get_inception(device=device)
    key = str(torch.device(device))
    with _LOCK:
        base = _CACHED[key][2]
        if source != "random-init":
            return base
        x = np.asarray(images01, np.float32)[:_CALIBRATION_CAP]
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, axis=-1)
        ck = (key, _calibration_key(x))
        if ck in _CALIB_CACHE:
            return _CALIB_CACHE[ck]
        bns = [m for m in model.modules() if isinstance(m, FrozenBN)]
        try:
            for m in bns:
                m.calibrating = True
            model(_to_input(x, device))
        finally:
            for m in bns:
                m.calibrating = False
        out = {k: v.clone() for k, v in model.named_buffers()}
        _load_stats(model, base)
        if len(_CALIB_CACHE) >= 8:
            _CALIB_CACHE.pop(next(iter(_CALIB_CACHE)))
        _CALIB_CACHE[ck] = out
        return out


def _load_stats(model: nn.Module, stats: Dict[str, torch.Tensor]) -> None:
    for name, buf in model.named_buffers():
        buf.copy_(stats[name])


@torch.no_grad()
def inception_features(images01, stats: Optional[Dict[str, torch.Tensor]] = None,
                       device="cpu", batch: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """Pool features and softmax probabilities (float64, on the host) for
    (n, H, W, C) images in [0, 1], in batches of ``batch``; ``stats`` picks
    the frozen BN statistics (a tracker's :func:`calibrated_stats`; default
    the base ones)."""
    model, _ = get_inception(device=device)
    key = str(torch.device(device))
    fs, ps = [], []
    with _LOCK:
        _load_stats(model, stats if stats is not None else _CACHED[key][2])
        for s in range(0, len(images01), batch):
            feats, logits = model(_to_input(images01[s:s + batch], device))
            fs.append(feats)
            ps.append(torch.softmax(logits, dim=-1))
        feats = torch.cat(fs).double().cpu().numpy()
        probs = torch.cat(ps).double().cpu().numpy()
    return feats, probs
