"""ResNet-18 relative-pose regressor (the JAX package's
``models/resnet_pose.py``, the reference's ``PoseEstimationNet``), NCHW.

torchvision's resnet18 with an ``in_channels`` stem (8: two RGB-D
frames), fc 512 -> 256, and the pose head ReLU, Dropout(.3), Linear
256->128, ReLU, Dropout(.2), Linear 128->64, ReLU, Dropout(.1), Linear
64->7; output ``[tx, ty, tz, qx, qy, qz, qw]``. Module names are the
reference's (``backbone.layer1.0.conv1``, ``backbone.layer2.0.downsample.0``,
``pose_head.2``, ...), so its state dict loads with ``load_state_dict``.

Parameters and BatchNorm statistics are f32; convolutions and linears
run in the dtype of the input (``PoseEstimationNet.dtype``: f32 for
'32-true', bf16 for 'bf16-mixed'), with the parameters cast at use.

BatchNorm (eps 1e-5, momentum 0.1) normalises as torch does, but in
training it folds the biased batch variance into the running variance,
as flax (and so the JAX package) does; torch folds the unbiased one.
Dropout draws from an explicit ``torch.Generator``.

Under data parallelism (``set_sync_group``) BatchNorm normalises with the
statistics of the global batch, as the JAX package does on its global
array: the per-channel sum and then the sum of squared deviations are
summed over the ranks (with their gradients), and the running variance
keeps the biased global variance. ``forward(rows=(offset, total))`` draws
the dropout masks of all ``total`` rows of the global batch and keeps
this rank's, so every rank's draw is the one-process run's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..parallel import mesh as meshlib


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance takes the biased batch
    variance in training."""

    sync_group = None  # the data group whose batch statistics it shares

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.sync_group is not None:
            return self._synced(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        # The op updates a copy (its backward may read the one it was
        # given) with m * var * n / (n - 1); the buffer keeps m * var.
        running_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, running_var, self.weight,
                         self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_(kept + (running_var - kept) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return y


    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Training BatchNorm over the global batch of the sync group."""
        group = self.sync_group
        xf = x.float()
        count = torch.tensor([float(xf.numel() // xf.shape[1])],
                             device=x.device)
        n = meshlib.all_reduce_sum(count, group)
        mean = meshlib.all_reduce_sum(xf.sum(dim=(0, 2, 3)), group) / n
        xc = xf - mean[None, :, None, None]
        var = meshlib.all_reduce_sum((xc * xc).sum(dim=(0, 2, 3)), group) / n
        y = xc * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight[None, :, None, None] + \
            self.bias[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def set_sync_group(model: nn.Module, group) -> None:
    """Share BatchNorm's training statistics over ``group`` (None: this
    rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(_conv(x, self.conv1)))
        out = self.bn2(_conv(out, self.conv2))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](_conv(x, self.downsample[0]))
        return F.relu(out + identity)


class Backbone(nn.Module):
    """torchvision resnet18 with an ``in_channels`` stem and fc -> 256."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        plan = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        for i, (cin, cout, stride) in enumerate(plan):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, cout, stride), BasicBlock(cout, cout)))
        self.fc = nn.Linear(512, 256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(_conv(x, self.conv1)))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return _linear(x.mean(dim=(2, 3)), self.fc)


class Dropout(nn.Module):
    """Dropout whose mask comes from the generator it is given."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """``rows`` (offset, total): ``x`` holds rows ``offset ..`` of a
        global batch of ``total``; the mask is drawn for all of them."""
        offset, total = rows or (0, x.shape[0])
        keep = torch.rand((total,) + tuple(x.shape[1:]), generator=generator,
                          device=x.device)[offset:offset + x.shape[0]] \
            >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class PoseEstimationNet(nn.Module):
    """(B, in_channels, H, W) -> (B, 7) f32 relative poses. ``dropout=False``
    makes the head deterministic in training (for parity tests)."""

    def __init__(self, in_channels: int = 8,
                 dtype: torch.dtype = torch.float32, dropout: bool = True):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.backbone = Backbone(in_channels)
        self.pose_head = nn.Sequential(
            nn.ReLU(), Dropout(0.3), nn.Linear(256, 128),
            nn.ReLU(), Dropout(0.2), nn.Linear(128, 64),
            nn.ReLU(), Dropout(0.1), nn.Linear(64, 7))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """In training with dropout on, ``generator`` (on x's device) draws
        the masks, for the global batch's ``rows`` (``Dropout``)."""
        drop = self.training and self.dropout
        if drop and generator is None:
            raise ValueError("training with dropout needs a generator")
        x = self.backbone(x.to(self.dtype))
        for layer in self.pose_head:
            if isinstance(layer, Dropout):
                x = layer(x, generator, rows) if drop else x
            elif isinstance(layer, nn.Linear):
                x = _linear(x, layer)
            else:
                x = layer(x)
        return x.float()


@torch.no_grad()
def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded LeCun-normal conv and linear weights (the JAX package's flax
    initialisers), zero biases; BatchNorm as torch builds it."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                             generator=gen)
            if m.bias is not None:
                m.bias.zero_()
    return model


def build_pose_model(in_channels: int = 8,
                     dtype: torch.dtype = torch.float32,
                     dropout: bool = True,
                     device: str | torch.device = "cuda",
                     seed: int = 0) -> PoseEstimationNet:
    """A seeded ``PoseEstimationNet`` on ``device`` (the card unless the
    caller asks for the CPU), in eval mode."""
    with resolve_device(device):
        model = PoseEstimationNet(in_channels, dtype, dropout)
    return init_random(model, seed).eval()
