"""Minimal MLP classifier -- the small end-to-end test model
(counterpart of ``mlsl_tpu.models.mlp``, same parameter layout)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mlsl_tpu_torch.core.environment import default_device
from mlsl_tpu_torch.models.convert import load_params
from mlsl_tpu_torch.models.resnet import Dense, cross_entropy

LAYERS = ["l1", "l2"]


class MLP(nn.Module):
    def __init__(self, din: int = 8, dh: int = 16, dout: int = 4,
                 generator: Optional[torch.Generator] = None, device=None, params=None):
        super().__init__()
        device = default_device() if device is None else device
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.l1 = Dense(gen, din, dh, device, std=0.3)
        self.l2 = Dense(gen, dh, dout, device, std=0.3)
        if params is not None:
            load_params(self, params)

    def jax_tree(self):
        return {"l1": self.l1.jax_tree(), "l2": self.l2.jax_tree()}

    def forward(self, x):
        return self.l2(torch.tanh(self.l1(x)))


def loss_fn(model: MLP, batch) -> torch.Tensor:
    x, y = batch
    return cross_entropy(model(x), y)


def get_layer(model: MLP, name: str):
    return model.jax_tree()[name]
