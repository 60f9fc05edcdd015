"""ResNet-50 as an ``nn.Module``, numerically matched to ``mlsl_tpu.models.resnet``.

Every parameter is stored in the JAX package's layout -- conv weights HWIO,
the dense weight (in, out) -- and permuted in ``forward``, so the per-layer
flat gradient orders its elements as the JAX version does (see convert.py).
The 18 layers (stem, 16 bottlenecks, fc) carry the same names and parameter
counts (resnet.py:182-208).

Numerics follow the JAX model: bfloat16 activations with float32 parameters;
train-mode batch norm with one-pass statistics (mean and E[x^2] in float32,
variance clamped at 0) taken on the local batch; average pooling in float32.
``SAME`` padding is asymmetric for the strided layers (the 7x7/2 stem at 224
pads (2, 3), the 3x3/2 convs and the 3x3/2 max-pool (0, 1)), so every layer
pads explicitly with ``F.pad`` (the pool with -inf). The TPU-only
space-to-depth stem is not carried over: the stem is the direct conv.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlsl_tpu_torch.core.environment import default_device
from mlsl_tpu_torch.models.convert import load_params, tree_leaves

STAGES = (3, 4, 6, 3)          # ResNet-50 bottleneck counts
WIDTHS = (256, 512, 1024, 2048)


def set_precision() -> None:
    """Full float32 for float32 products: the dense layer's matmul and any
    float32 convolution. Convolutions run in bfloat16, which TF32 does not
    touch; the flags are set so that nothing silently drops to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _normal(gen, shape, std, device):
    t = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return nn.Parameter(t.to(device))


def _conv_param(gen, kh, kw, cin, cout, device):
    return _normal(gen, (kh, kw, cin, cout), float(np.sqrt(2.0 / (kh * kw * cin))), device)


def _same_pad(size: int, k: int, s: int):
    """XLA's SAME padding along one dim -> (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of NCHW x with an HWIO weight, in x's dtype."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    w = w_hwio.to(x.dtype).permute(3, 2, 0, 1)
    return F.conv2d(x, w, stride=stride)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    ph = _same_pad(x.shape[2], k, s)
    pw = _same_pad(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Folded train-mode BN over (N, H, W) of NCHW x, one-pass statistics in
    float32 (mlsl_tpu/models/resnet.py:67-86)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(0, 2, 3))
    msq = (xf * xf).mean(dim=(0, 2, 3))
    var = torch.clamp_min(msq - mean * mean, 0.0)
    a = torch.rsqrt(var + eps) * scale
    b = bias - mean * a
    return (x * a[None, :, None, None] + b[None, :, None, None]).to(x.dtype)


class BatchNorm(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def jax_tree(self):
        return {"scale": self.scale, "bias": self.bias}

    def forward(self, x):
        return batch_norm(x, self.scale, self.bias)


class Stem(nn.Module):
    def __init__(self, gen, device):
        super().__init__()
        self.conv = _conv_param(gen, 7, 7, 3, 64, device)
        self.bn = BatchNorm(64, device)

    def jax_tree(self):
        return {"conv": self.conv, "bn": self.bn.jax_tree()}

    def forward(self, x):
        return max_pool_same(F.relu(self.bn(conv(x, self.conv, 2))))


class Bottleneck(nn.Module):
    def __init__(self, gen, cin: int, width: int, proj: bool, device):
        super().__init__()
        mid = width // 4
        self.conv1 = _conv_param(gen, 1, 1, cin, mid, device)
        self.bn1 = BatchNorm(mid, device)
        self.conv2 = _conv_param(gen, 3, 3, mid, mid, device)
        self.bn2 = BatchNorm(mid, device)
        self.conv3 = _conv_param(gen, 1, 1, mid, width, device)
        self.bn3 = BatchNorm(width, device)
        if proj:
            self.proj = _conv_param(gen, 1, 1, cin, width, device)
            self.bn_proj = BatchNorm(width, device)
        else:
            self.proj = None

    def jax_tree(self):
        t = {
            "conv1": self.conv1, "bn1": self.bn1.jax_tree(),
            "conv2": self.conv2, "bn2": self.bn2.jax_tree(),
            "conv3": self.conv3, "bn3": self.bn3.jax_tree(),
        }
        if self.proj is not None:
            t["proj"] = self.proj
            t["bn_proj"] = self.bn_proj.jax_tree()
        return t

    def forward(self, x, stride: int):
        y = F.relu(self.bn1(conv(x, self.conv1)))
        y = F.relu(self.bn2(conv(y, self.conv2, stride)))
        y = self.bn3(conv(y, self.conv3))
        if self.proj is not None:
            x = self.bn_proj(conv(x, self.proj, stride))
        return F.relu(x + y)


class Dense(nn.Module):
    def __init__(self, gen, din: int, dout: int, device, std: float = 0.01):
        super().__init__()
        self.w = _normal(gen, (din, dout), std, device)
        self.b = nn.Parameter(torch.zeros(dout, device=device))

    def jax_tree(self):
        return {"w": self.w, "b": self.b}

    def forward(self, x):
        return x @ self.w + self.b


class ResNet50(nn.Module):
    """x: (N, H, W, 3) float -> logits (N, num_classes)."""

    def __init__(self, num_classes: int = 1000, generator: Optional[torch.Generator] = None,
                 device=None, params=None):
        super().__init__()
        set_precision()
        device = default_device() if device is None else device
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.stem = Stem(gen, device)
        cin = 64
        self.stages = nn.ModuleList()
        for blocks, width in zip(STAGES, WIDTHS):
            stage = nn.ModuleList()
            for bi in range(blocks):
                stage.append(Bottleneck(gen, cin, width, bi == 0, device))
                cin = width
            self.stages.append(stage)
        self.fc = Dense(gen, 2048, num_classes, device)
        if params is not None:
            load_params(self, params)

    def jax_tree(self):
        t = {"stem": self.stem.jax_tree(), "fc": self.fc.jax_tree()}
        for si, stage in enumerate(self.stages):
            t[f"stage{si}"] = [b.jax_tree() for b in stage]
        return t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        x = self.stem(x)
        for si, stage in enumerate(self.stages):
            for bi, block in enumerate(stage):
                x = block(x, 2 if (bi == 0 and si > 0) else 1)
        x = x.to(torch.float32).mean(dim=(2, 3))   # pool accumulates in f32
        return self.fc(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def loss_fn(model: ResNet50, batch) -> torch.Tensor:
    x, labels = batch
    return cross_entropy(model(x), labels)


def layer_names(model: Optional[ResNet50] = None) -> List[str]:
    """Flat per-layer names in forward order -- one Operation per entry."""
    names = ["stem"]
    for si, blocks in enumerate(STAGES):
        names += [f"stage{si}.{bi}" for bi in range(blocks)]
    names.append("fc")
    return names


def layer_subtree(model: ResNet50, name: str):
    if name == "stem":
        return model.stem.jax_tree()
    if name == "fc":
        return model.fc.jax_tree()
    stage, block = name.split(".")
    return model.stages[int(stage[len("stage"):])][int(block)].jax_tree()


def layer_param_counts(model: ResNet50) -> Dict[str, int]:
    """name -> total parameter element count (the Operation's kernel count)."""
    return {n: sum(p.numel() for p in tree_leaves(layer_subtree(model, n)))
            for n in layer_names(model)}
