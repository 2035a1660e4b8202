"""The paper's own benchmark models: ResNet-20 and VGG-16 for CIFAR-10.

Port of ``repro/models/cnn.py``. The parameters keep the reference's
shapes: HWIO conv weights, (C,) group-norm scale and bias, (C, classes)
fc weight, in nested dicts that ``core.count_sketch.ravel_tree`` flattens
in the reference's order. Images come in NHWC, as the reference's;
inside, activations are NCHW (torch's conv layout), and each conv
permutes its HWIO weight to OIHW.

As in the reference, BatchNorm is replaced by GroupNorm(8): running batch
statistics are ill-defined with one model copy a simulated worker, and
every compressor sees the identical model.

SAME padding is XLA's: for input n, kernel k and stride s the total
padding is max((ceil(n/s) - 1)*s + k - n, 0), the smaller half before.
A 3x3 conv at stride 2 on an even input therefore pads 0 before and 1
after (``F.conv2d(padding=1)`` would read a window shifted by one pixel).

``_he`` draws from a ``torch.Generator``: the same distribution as the
reference's ``jax.random`` draw, not the same numbers.
``params_from_reference`` carries the reference's parameters across.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding (before, after) of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with HWIO weight ``w`` -> NCHW."""
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = (_same_pads(x.shape[2], kh, stride),
              _same_pads(x.shape[3], kw, stride))
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 8) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` over ``min(groups, C)`` groups of
    consecutive channels (the reference's reshape), biased variance in
    f32, eps 1e-5, then ``* (1 + scale) + bias``."""
    g = min(groups, x.shape[1])
    y = F.group_norm(x.to(torch.float32), g, 1.0 + scale, bias, eps=1e-5)
    return y.to(x.dtype)


def _he(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in = shape[0] * shape[1] * shape[2] if len(shape) == 4 else shape[0]
    return torch.randn(shape, generator=gen, device=gen.device) * float(
        np.sqrt(2.0 / fan_in))


def _zeros(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros(n, device=gen.device)


# ---------------------------------------------------------------------------
# ResNet-20 (CIFAR): 3 stages x 3 basic blocks, widths (16, 32, 64)
# ---------------------------------------------------------------------------


def init_resnet20(gen: torch.Generator, n_classes: int = 10,
                  width: int = 16) -> dict:
    """ResNet-20's parameters on ``gen``'s device."""
    p: dict = {"stem": {"w": _he(gen, (3, 3, 3, width)),
                        "s": _zeros(gen, width), "b": _zeros(gen, width)}}
    c_in = width
    for s, mult in enumerate((1, 2, 4)):
        c_out = width * mult
        for b in range(3):
            blk = {
                "w1": _he(gen, (3, 3, c_in, c_out)),
                "s1": _zeros(gen, c_out), "b1": _zeros(gen, c_out),
                "w2": _he(gen, (3, 3, c_out, c_out)),
                "s2": _zeros(gen, c_out), "b2": _zeros(gen, c_out),
            }
            if c_in != c_out:
                blk["proj"] = _he(gen, (1, 1, c_in, c_out))
            p[f"s{s}b{b}"] = blk
            c_in = c_out
    p["fc"] = {"w": _he(gen, (c_in, n_classes)),
               "b": _zeros(gen, n_classes)}
    return p


def resnet20_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 32, 32, 3) NHWC -> (N, n_classes)."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_groupnorm(_conv(h, p["stem"]["w"]),
                          p["stem"]["s"], p["stem"]["b"]))
    for s in range(3):
        for b in range(3):
            blk = p[f"s{s}b{b}"]
            stride = 2 if (s > 0 and b == 0) else 1
            y = F.relu(_groupnorm(_conv(h, blk["w1"], stride),
                                  blk["s1"], blk["b1"]))
            y = _groupnorm(_conv(y, blk["w2"]), blk["s2"], blk["b2"])
            sc = _conv(h, blk["proj"], stride) if "proj" in blk else h
            h = F.relu(sc + y)
    h = h.mean(dim=(2, 3))
    return h @ p["fc"]["w"] + p["fc"]["b"]


# ---------------------------------------------------------------------------
# VGG-16 (CIFAR variant): conv stacks (2,2,3,3,3), widths (64..512), 1 FC
# ---------------------------------------------------------------------------

_VGG_PLAN = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def init_vgg16(gen: torch.Generator, n_classes: int = 10,
               width_mult: float = 1.0) -> dict:
    """VGG-16's parameters on ``gen``'s device."""
    p: dict = {}
    c_in = 3
    for s, (reps, c) in enumerate(_VGG_PLAN):
        c_out = max(8, int(c * width_mult))
        for r in range(reps):
            p[f"s{s}c{r}"] = {"w": _he(gen, (3, 3, c_in, c_out)),
                              "s": _zeros(gen, c_out),
                              "b": _zeros(gen, c_out)}
            c_in = c_out
    p["fc"] = {"w": _he(gen, (c_in, n_classes)),
               "b": _zeros(gen, n_classes)}
    return p


def vgg16_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 32, 32, 3) NHWC -> (N, n_classes); a 2x2 VALID max-pool
    after each stack."""
    h = x.permute(0, 3, 1, 2)
    for s, (reps, _) in enumerate(_VGG_PLAN):
        for r in range(reps):
            blk = p[f"s{s}c{r}"]
            h = F.relu(_groupnorm(_conv(h, blk["w"]), blk["s"], blk["b"]))
        h = F.max_pool2d(h, 2)
    h = h.mean(dim=(2, 3))
    return h @ p["fc"]["w"] + p["fc"]["b"]


MODELS = {
    "resnet20": (init_resnet20, resnet20_logits),
    "vgg16": (init_vgg16, vgg16_logits),
}


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy, ``log_softmax`` in f32."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(1, labels.reshape(-1, 1).to(torch.int64)).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def loss_and_acc(apply, params: dict, images: torch.Tensor,
                 labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    logits = apply(params, images)
    return ce_loss(logits, labels), accuracy(logits, labels)


def params_from_reference(tree, device="cpu") -> dict:
    """The reference's parameter dict (numpy or array-like leaves, the
    reference's shapes) -> the port's, as f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
