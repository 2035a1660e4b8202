"""The plain reference: a dense llama-style model trained by gs-SGD with
AdamW, in plain PyTorch with float32 matmuls (TF32 off), P simulated
workers on one device.

It imports nothing of the program and takes nothing the program made:
it is handed the seeded initial parameters and batches (``inputs``),
lays the parameters out by ``layout``, and works the rest out itself.

One step, as the gs-SGD paper's Algorithm 1 with error feedback:

    for each worker w: loss_w, g_w = forward + backward on its rows
                       u_w = e_w + g_w
    for each bucket:   S = sum_w Sketch(u_w)          (Count-Sketch)
                       I = HEAVYMIX(S, k)             (the top-k)
                       v = sum_w u_w[I]               (exact values)
                       update[I] = v;  e_w = u_w with I zeroed
    AdamW(params, update / P)

The model: token embedding, then per layer a pre-norm attention block
(RMSNorm with its gain stored as a delta around 1, rotary embedding with
the halves rotated, causal softmax attention, key/value heads shared by
groups of query heads) and a pre-norm SwiGLU MLP, each added to the
residual; a final RMSNorm and the head (the embedding's transpose when
tied); the mean next-token cross entropy over the real vocabulary
(labels < 0 ignored). Each layer is checkpointed so that the backward
holds one layer's attention at a time.

``Reference(..., tf32=True)`` is the control (the same arithmetic with
TF32 matmuls); ``fault=`` plants one of the faults the check must catch
(``FAULTS``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pbench import inputs
from pbench import layout as lay_mod
from pbench import sketch_ref

FAULTS = ("half_batch", "no_exchange")


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matmuls (TF32 off), or TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x, delta, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + delta)


def rope(x, theta):
    """x (B, S, H, hd): positions 0..S-1, the two halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, wq, wk, wv, wo, norm, s: lay_mod.Shape):
    B, S, _ = x.shape
    hd, H, Hkv = s.head_dim, s.n_heads, s.n_kv_heads
    h = rmsnorm(x, norm, s.norm_eps)
    q = rope((h @ wq).reshape(B, S, H, hd), s.rope_theta).transpose(1, 2)
    k = rope((h @ wk).reshape(B, S, Hkv, hd), s.rope_theta).transpose(1, 2)
    v = (h @ wv).reshape(B, S, Hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) * hd ** -0.5
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    o = (p @ v).transpose(1, 2).reshape(B, S, H * hd)
    return x + o @ wo


def mlp(x, wg, wu, wo, norm, s: lay_mod.Shape):
    h = rmsnorm(x, norm, s.norm_eps)
    return x + (F.silu(h @ wg) * (h @ wu)) @ wo


def layer(x, wq, wk, wv, wo, norm, mwg, mwu, mwo, mnorm, s):
    return mlp(attention(x, wq, wk, wv, wo, norm, s), mwg, mwu, mwo, mnorm,
               s)


def loss_and_grad(flat: torch.Tensor, lay: lay_mod.Layout, tokens, labels
                  ) -> tuple[float, torch.Tensor]:
    """The mean next-token cross entropy of ``tokens`` -> ``labels`` and
    its gradient as one flat (d,) f32 vector."""
    s = lay.shape
    leaves = {l.name: flat[l.offset:l.offset + l.size].view(l.shape)
              .detach().requires_grad_() for l in lay.leaves}
    with torch.enable_grad():
        x = leaves["embed"][tokens]
        for c in range(s.n_layers):
            w = [leaves[f"layer{c}/{n}"] for n in (
                "wq", "wk", "wv", "wo", "norm", "mlp/wg", "mlp/wu",
                "mlp/wo", "mlp/norm")]
            x = checkpoint(layer, x, *w, s, use_reentrant=False)
        h = rmsnorm(x, leaves["final_norm"], s.norm_eps)
        head = (leaves["embed"].t() if s.tie_embeddings
                else leaves["head"])[:, :s.vocab_size]
        logits = h @ head
        loss = F.cross_entropy(logits.reshape(-1, s.vocab_size),
                               labels.reshape(-1), ignore_index=-1)
        loss.backward()
    grad = torch.zeros_like(flat)
    for l in lay.leaves:
        g = leaves[l.name].grad
        if g is not None:
            grad[l.offset:l.offset + l.size] = g.reshape(-1)
    return float(loss.detach()), grad


class Reference:
    """gs-SGD + AdamW over P simulated workers (module docstring).

    ``conf``/``traffic``: the cell's configuration and traffic files;
    ``seed``: the inputs' seed."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device, *,
                 tf32: bool = False, fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device, self.tf32, self.fault = device, tf32, fault
        self.lay = lay_mod.layout(lay_mod.Shape.of(conf))
        self.P = int(traffic["workers"])
        ex = conf["exchange"]
        self.buckets, off = [], 0
        for b in ex["buckets"]:
            sk = sketch_ref.Sketch(ex["rows"], b["width"], b["hash_seed"],
                                   device)
            self.buckets.append((off, int(b["d"]), int(b["k"]), sk))
            off += int(b["d"])
        if off != self.lay.d:
            raise ValueError(f"the buckets cover {off} of {self.lay.d} "
                             "coordinates")
        o = conf["optimizer"]
        self.lr, self.b1, self.b2 = o["lr"], o["b1"], o["b2"]
        self.eps, self.wd = o["eps"], o["weight_decay"]
        self.params = inputs.initial_params(self.lay, seed, device)
        self.m = torch.zeros_like(self.params)
        self.v = torch.zeros_like(self.params)
        self.ef = torch.zeros((self.P, self.lay.d), dtype=torch.float32,
                              device=device)
        self.t = 0

    def _rows(self, gb: dict, w: int) -> tuple:
        n = int(self.traffic["seqs_per_worker"])
        tok = gb["tokens"][w * n:(w + 1) * n]
        lab = gb["labels"][w * n:(w + 1) * n]
        if self.fault == "half_batch":   # the second half's labels dropped
            lab = lab.clone()
            lab[:, lab.shape[1] // 2:] = -1
        return tok, lab

    def step(self) -> dict:
        """One step on this step's batch. Returns the mean loss over the
        workers, the update the optimizer got (update / P) and the mean
        of the workers' dense gradients."""
        gb = inputs.batch(self.lay.shape, self.traffic, self.seed, self.t,
                          self.device)
        losses = []
        dense = torch.zeros_like(self.params)
        with matmul_precision(self.tf32):
            for w in range(self.P):
                loss, g = loss_and_grad(self.params, self.lay,
                                        *self._rows(gb, w))
                losses.append(loss)
                dense += g
                self.ef[w] += g          # u_w = e_w + g_w, in place
                del g
        update = torch.zeros_like(self.params)
        senders = range(1) if self.fault == "no_exchange" else range(self.P)
        for off, n, k, sk in self.buckets:
            total = None
            for w in senders:
                s_w = sk.encode(self.ef[w, off:off + n])
                total = s_w if total is None else total + s_w
            idx = sketch_ref.heavymix(total, sk, k, n) + off
            vals = None
            for w in senders:
                u = self.ef[w, idx]
                vals = u if vals is None else vals + u
            update[idx] = vals
            self.ef[:, idx] = 0.0         # e_w = u_w with I zeroed
        update /= self.P
        self._adamw(update)
        self.t += 1
        return {"loss": sum(losses) / self.P, "update": update,
                "dense": dense.div_(self.P)}

    def _adamw(self, g: torch.Tensor) -> None:
        t = self.t + 1
        self.m.mul_(self.b1).add_((1 - self.b1) * g)
        self.v.mul_(self.b2).add_((1 - self.b2) * g * g)
        upd = (self.m / (1 - self.b1 ** t)) / (
            torch.sqrt(self.v / (1 - self.b2 ** t)) + self.eps)
        upd.add_(self.wd * self.params)
        self.params.sub_(self.lr * upd)
