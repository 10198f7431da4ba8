"""Small conv-net family for image classification, in PyTorch.

Counterpart of ``dlrover_tpu/models/cnn.py`` (the MNIST CNN: conv, pool,
conv, pool, fc, fc), in fp32. The batch keeps the JAX layout, NHWC
images ``[batch, H, W, C]``; the convolutions run NCHW on OIHW weights
(``params_from_jax`` permutes the JAX package's HWIO), and the features
go back to NHWC before the flatten, so ``fc1``'s rows pair with the
same features as the JAX model's. Convolutions are 3x3, stride 1, SAME;
pooling is max 2x2, stride 2, VALID. Negative labels (the elastic
examples' tail-shard padding) are masked out of the cross-entropy.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dlrover_tpu_torch.auto.device_context import resolve_device
from dlrover_tpu_torch.models.llama import _masked_nll, _tensor


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    image_size: int = 28
    channels: int = 1
    num_classes: int = 10
    conv_features: Tuple[int, int] = (32, 64)
    hidden: int = 128
    dtype: torch.dtype = torch.float32

    # -- the models contract's names (the auto layer reads them) ------
    @property
    def hidden_size(self) -> int:
        return self.hidden

    @property
    def num_layers(self) -> int:
        return len(self.conv_features)

    @property
    def vocab_size(self) -> int:
        return self.num_classes


def mnist_cnn(**kw) -> CNNConfig:
    return CNNConfig(**kw)


def _flat(cfg: CNNConfig) -> int:
    s = cfg.image_size // 4  # two stride-2 pools
    return s * s * cfg.conv_features[1]


def param_count(cfg: CNNConfig) -> int:
    c1, c2 = cfg.conv_features
    return (
        9 * cfg.channels * c1 + c1
        + 9 * c1 * c2 + c2
        + _flat(cfg) * cfg.hidden + cfg.hidden
        + cfg.hidden * cfg.num_classes + cfg.num_classes
    )


def flops_per_token(cfg: CNNConfig, seq_len: int = 1) -> float:
    """Forward FLOPs per example (the contract's "token" is one image),
    the JAX package's formula."""
    c1, c2 = cfg.conv_features
    hw = cfg.image_size * cfg.image_size
    return float(
        2 * hw * 9 * cfg.channels * c1
        + 2 * (hw // 4) * 9 * c1 * c2
        + 2 * _flat(cfg) * cfg.hidden
        + 2 * cfg.hidden * cfg.num_classes
    )


class CNN(nn.Module):
    """conv-relu-pool, conv-relu-pool, fc-relu, fc. Its parameters are
    left uninitialized: ``init_params`` draws them, ``params_from_jax``
    loads them."""

    def __init__(self, cfg: CNNConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        c1, c2 = cfg.conv_features
        self.cfg = cfg
        kw = {"device": device, "dtype": cfg.dtype}
        self.conv1 = nn.Conv2d(cfg.channels, c1, 3, padding=1, **kw)
        self.conv2 = nn.Conv2d(c1, c2, 3, padding=1, **kw)
        self.fc1 = nn.Linear(_flat(cfg), cfg.hidden, **kw)
        self.fc2 = nn.Linear(cfg.hidden, cfg.num_classes, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [batch, H, W, C] -> fp32 logits [batch, num_classes]."""
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        # flatten in NHWC order, as the JAX model does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x))).float()


def init_params(cfg: CNNConfig, seed: int = 0, device=None) -> CNN:
    """He-normal weights (std sqrt(2 / fan_in)), zero biases, as the JAX
    package draws them, from a ``torch.Generator`` seeded with ``seed``
    (the numbers differ from ``jax.random``'s)."""
    model = CNN(cfg, device)
    dev = model.fc1.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for module in (model.conv1, model.conv2, model.fc1, model.fc2):
            w = module.weight  # OIHW or [out, in]: fan_in is the rest
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=gen, device=dev,
                                dtype=torch.float32) * (2.0 / fan_in) ** 0.5)
            module.bias.zero_()
    return model


def loss_sums(model: CNN, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch = (images [b, H, W, C], labels int [b]) -> (the summed
    cross-entropy over labels >= 0, their count)."""
    images, labels = batch
    return _masked_nll(model(images), labels)


def loss(model: CNN, batch) -> torch.Tensor:
    """The mean cross-entropy over labels >= 0 (see :func:`loss_sums`)."""
    nll_sum, cnt = loss_sums(model, batch)
    return nll_sum / cnt.clamp(min=1.0)


#: the models contract's name: the trainer layers call next_token_loss
next_token_loss = loss


def make_trainer(cfg: CNNConfig, device=None, strategy: str = "ddp",
                 accum_steps: int = 1, optimizer=None, attn_fn=None):
    """Trainer for the CNN; ``device=None`` is the GPU."""
    from dlrover_tpu_torch.trainer.sharded import family_trainer

    return family_trainer(
        cfg, loss_sums,
        lambda seed, dev: init_params(cfg, seed=seed, device=dev),
        param_count(cfg), device=device, strategy=strategy,
        accum_steps=accum_steps, optimizer=optimizer)


def example_batch(cfg: CNNConfig, global_batch: int, seq_len: int = 1):
    """Zero-filled (images, labels)."""
    images = np.zeros(
        (global_batch, cfg.image_size, cfg.image_size, cfg.channels),
        np.float32)
    return images, np.zeros((global_batch,), np.int32)


def params_from_jax(np_tree: Dict, cfg: CNNConfig, device=None) -> CNN:
    """The port's model holding the JAX model's weights: HWIO kernels
    permuted to OIHW, ``[in, out]`` matrices transposed."""
    state = {
        "conv1.weight": _tensor(np_tree["conv1"]).permute(3, 2, 0, 1),
        "conv1.bias": _tensor(np_tree["b1"]),
        "conv2.weight": _tensor(np_tree["conv2"]).permute(3, 2, 0, 1),
        "conv2.bias": _tensor(np_tree["b2"]),
        "fc1.weight": _tensor(np_tree["fc1"]).T,
        "fc1.bias": _tensor(np_tree["fb1"]),
        "fc2.weight": _tensor(np_tree["fc2"]).T,
        "fc2.bias": _tensor(np_tree["fb2"]),
    }
    model = CNN(cfg, device)
    model.load_state_dict(state)
    return model
