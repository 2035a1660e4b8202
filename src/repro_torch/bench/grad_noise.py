"""Rounding noise of one worker's CNN gradient, against float64.

The first step of the paper's cell (``cnn_dist``: params from seed 0,
``ImageStream`` seed 0, global batch 32 over P = 4 workers): each worker's
f32 gradient on the run's device (the card unless ``--device cpu``; on the
card cuDNN deterministic, TF32 off) and the same gradient in float64 on
the CPU. Prints, per worker, the largest absolute difference and the leaf
that holds it, and the count of coordinates off by more than 1e-3 of
their leaf's largest |g|. A pre-activation within rounding of 0 that
falls on the other side of a ReLU moves the gradient of the weights
behind it well past f32 rounding: this is the noise against which two
devices' (or packages') selections can differ at the k-th score.

    python -m repro_torch.bench.grad_noise [--device cpu]
        [--model resnet20|vgg16]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch.bench import cnn_dist
from repro_torch.core import count_sketch as cs
from repro_torch.data import ImageStream
from repro_torch.models import cnn

P, GLOBAL_BATCH = 4, 32


def _f64_norm_and_loss():
    """``cnn._groupnorm`` and ``cnn.ce_loss`` without their f32 casts."""
    def gn(x, scale, bias, groups=8):
        return F.group_norm(x, min(groups, x.shape[1]), 1.0 + scale, bias,
                            eps=1e-5)

    def ce(logits, labels):
        return -F.log_softmax(logits, -1).gather(
            1, labels.reshape(-1, 1)).mean()

    return gn, ce


def worker_grad(model, flat, info, images, labels, dtype) -> torch.Tensor:
    """One worker's flat gradient in ``dtype`` on ``flat``'s device."""
    _, apply = cnn.MODELS[model]
    tree, leaves = cnn_dist.grad_leaves(
        flat.to(dtype), (info[0], [(s, dtype) for s, _ in info[1]]))
    with torch.enable_grad():
        loss = cnn.ce_loss(apply(tree, images.to(dtype)), labels)
        grads = torch.autograd.grad(loss, leaves)
    return torch.cat([g.reshape(-1) for g in grads]).double().cpu()


def main(device=None, model: str = "resnet20") -> list[dict]:
    device = cnn_dist.prepare_device(device)
    params = cnn_dist.init_params(model, "cpu")
    flat, info = cs.ravel_tree(params)
    names = [(f"{k}.{j}", params[k][j].numel()) for k in sorted(params)
             for j in sorted(params[k])]
    b = ImageStream(global_batch=GLOBAL_BATCH, seed=0).global_batch_at(0)
    per, out = GLOBAL_BATCH // P, []
    for p in range(P):
        x, y = (b[key][p * per:(p + 1) * per]
                for key in ("images", "labels"))
        g32 = worker_grad(model, flat.to(device), info, x.to(device),
                          y.to(device), torch.float32)
        saved = cnn._groupnorm, cnn.ce_loss
        cnn._groupnorm, cnn.ce_loss = _f64_norm_and_loss()
        try:
            g64 = worker_grad(model, flat, info, x, y, torch.float64)
        finally:
            cnn._groupnorm, cnn.ce_loss = saved
        err, off, worst, far = 0.0, 0, "", 0
        for name, n in names:
            e = (g32[off:off + n] - g64[off:off + n]).abs()
            scale = float(g64[off:off + n].abs().max())
            far += int((e > 1e-3 * scale).sum())
            if float(e.max()) > err:
                err, worst = float(e.max()), name
            off += n
        row = {"worker": p, "max_abs_err": err, "leaf": worst,
               "coords_off_1e-3_of_leaf_max": far,
               "max_abs_g": float(g64.abs().max())}
        out.append(row)
        print(f"{model} worker {p} on {device.type}: f32 vs f64 max abs "
              f"err {err:.3g} in {worst} (max |g| {row['max_abs_g']:.3g}); "
              f"{far} coordinates off by > 1e-3 of their leaf's max |g|",
              flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--model", default="resnet20",
                    choices=sorted(cnn.MODELS))
    main(**vars(ap.parse_args()))
