"""Training forward for the dense family (tp=1): embed -> cycles -> norm -> CE.

Port of ``repro/models/model.py`` (``_backbone`` and ``loss_fn``,
``mode="train"``). Parameters arrive as flat segments
(``flatten.FlatSpec``); the per-cycle views are sliced from the cycle
segments, so autograd lands the gradient of every leaf in its segment.

``remat``: accepted for interface parity and a numerical no-op here. The
reference's sqrt-n remat only trades memory for recompute; at the slice's
depth (2 cycles) and sequence length the activations are small next to
the optimizer state, so the port keeps them.

``chunked_loss_vjp`` is the same forward with the graph cut at K chunk
boundaries of the cycle stack, so the backward can run (and emit each
chunk's cycle gradients) one chunk at a time.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig, tree_map
from repro_torch.models.flatten import FlatSpec, chunk_plan
from repro_torch.models.layers import (attention_block, embed_lookup,
                                       lm_loss, mlp_block, rmsnorm)


def _apply_cycle(cfg: ArchConfig, cyc_p: dict, x: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    occ: dict[str, int] = {}
    for kind in cfg.cycle:
        j = occ.get(kind, 0)
        occ[kind] = j + 1
        if kind != "attn" or cfg.parallel_block:
            raise NotImplementedError(
                f"block kind {kind!r} (parallel_block={cfg.parallel_block})"
                " is not ported yet")
        p = tree_map(lambda a: a[j], cyc_p[kind])
        x = attention_block(p, cfg, x, pos)
        x = mlp_block(p["mlp"], cfg, x)
    return x


def _backbone(cfg: ArchConfig, fs: FlatSpec, segs: dict,
              tokens: torch.Tensor, pos: torch.Tensor,
              dtype: torch.dtype) -> tuple[torch.Tensor, dict]:
    """Embed -> cycles -> final norm. Returns (hidden, top params)."""
    top = fs.top_params(segs["top_s"], segs["top_r"], dtype)
    x = embed_lookup(top["embed"], tokens, dtype)
    cs, cr = segs["cycles_s"], segs["cycles_r"]
    for c in range(fs.n_cycles):
        x = _apply_cycle(cfg, fs.cycle_params(cs[c], cr[c], dtype), x, pos)
    return rmsnorm(x, top["final_norm"], cfg.norm_eps), top


def _head_w(cfg: ArchConfig, top: dict) -> torch.Tensor:
    return top["embed"].T if cfg.tie_embeddings else top["head"]


def loss_fn(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch: dict, *,
            dtype: torch.dtype = torch.float32,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token CE. batch: tokens/labels (B, S)."""
    del remat  # see module docstring
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    hid, top = _backbone(cfg, fs, segs, tokens, pos, dtype)
    return lm_loss(hid, _head_w(cfg, top), batch["labels"], cfg)


def chunked_loss_vjp(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch: dict,
                     *, chunks: int, dtype: torch.dtype = torch.float32,
                     remat: bool = True):
    """Training forward with the cycle stack cut into K autograd chunks.

    Port of ``repro/models/model.py:chunked_loss_vjp``. The forward runs
    now, as K + 2 graphs: the embed prologue, one per chunk of cycles
    (``flatten.chunk_plan``) and the final-norm + loss epilogue. Each
    chunk's input carry is ``detach().requires_grad_()`` of the previous
    stage's output, and each chunk's rows ``cycles_s[a:b]`` /
    ``cycles_r[a:b]`` are leaves of their own, so a chunk's
    ``torch.autograd.grad`` yields its cycle gradients and the carry's
    cotangent and nothing else. ``top_s`` / ``top_r`` are one leaf each,
    read by every stage through its own views.

    Returns ``(loss, bwd_steps, top_grads)``, the reference's contract:

      loss       -- 0-dim tensor (detached), ``loss_fn``'s value.
      bwd_steps  -- K thunks to call STRICTLY in order. Step j runs chunk
                    K-1-j's backward and returns ``((a, b), d_cs, d_cr)``:
                    the chunk's cycle rows and its (b-a, f) gradients.
                    Step 0 first runs the epilogue's backward; the last
                    step also runs the prologue's.
      top_grads  -- thunk, to call once after every step ran:
                    ``(d_top_s, d_top_r)``, accumulated in the reference's
                    order (epilogue, chunks K-1..0, prologue).

    A stage that reads no top parameter (a dense chunk) gives ``None``
    for them (``allow_unused``), and nothing is added: no zero tensor the
    size of ``top_s`` is made for it. Each stage's graph is freed by its
    backward. The gradients are the monolithic backward's: the same chain
    rule over the same graph pieces, and each top coordinate receives at
    most two contributions (tied embeddings: the lookup and the head),
    whose sum is exact in any order.
    """
    del remat  # see module docstring
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    bounds = chunk_plan(fs.n_cycles, chunks)
    K = len(bounds)
    ts = segs["top_s"].detach().requires_grad_()
    tr = segs["top_r"].detach().requires_grad_()
    stages = []   # per chunk: (carry in, carry out, cs leaf, cr leaf)
    with torch.enable_grad():
        top = fs.top_params(ts, tr, dtype)
        pro_out = embed_lookup(top["embed"], tokens, dtype)
        x = pro_out
        for a, b in bounds:
            x_in = x.detach().requires_grad_()
            vs = segs["cycles_s"][a:b].detach().requires_grad_()
            vr = segs["cycles_r"][a:b].detach().requires_grad_()
            y = x_in
            for c in range(b - a):
                y = _apply_cycle(cfg, fs.cycle_params(vs[c], vr[c], dtype), y,
                                 pos)
            stages.append((x_in, y, vs, vr))
            x = y
        epi_in = x.detach().requires_grad_()
        top = fs.top_params(ts, tr, dtype)
        hid = rmsnorm(epi_in, top["final_norm"], cfg.norm_eps)
        loss = lm_loss(hid, _head_w(cfg, top), batch["labels"], cfg)
    del top, hid, x

    st: dict = {"d_ts": None, "d_tr": None}

    def acc_top(d_ts, d_tr):
        for name, g in (("d_ts", d_ts), ("d_tr", d_tr)):
            if g is not None:
                st[name] = g if st[name] is None else st[name].add_(g)

    def grad(out, inputs, cot):
        return torch.autograd.grad(out, inputs, grad_outputs=cot,
                                   allow_unused=True)

    def make_step(j: int):
        c = K - 1 - j
        a, b = bounds[c]

        def run():
            if j == 0:
                st["d_carry"], d_ts, d_tr = grad(loss, (epi_in, ts, tr),
                                                 torch.ones_like(loss))
                acc_top(d_ts, d_tr)
            x_in, y, vs, vr = stages[c]
            stages[c] = None
            d_carry, d_cs, d_cr, d_ts, d_tr = grad(
                y, (x_in, vs, vr, ts, tr), st.pop("d_carry"))
            acc_top(d_ts, d_tr)
            if c == 0:  # embed backward: the top segments' last piece
                acc_top(*grad(pro_out, (ts, tr), d_carry))
            else:
                st["d_carry"] = d_carry
            return ((a, b), torch.zeros_like(vs) if d_cs is None else d_cs,
                    torch.zeros_like(vr) if d_cr is None else d_cr)

        return run

    def top_grads():
        d_ts, d_tr = st.pop("d_ts"), st.pop("d_tr")
        return (torch.zeros_like(ts) if d_ts is None else d_ts,
                torch.zeros_like(tr) if d_tr is None else d_tr)

    return loss.detach(), [make_step(j) for j in range(K)], top_grads
