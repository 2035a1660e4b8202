"""Training forward for every family (tp=1): embed -> cycles -> norm -> CE.

Port of ``repro/models/model.py`` (``_apply_cycle``, ``_backbone`` and
``loss_fn``, ``mode="train"``). Parameters arrive as flat segments
(``flatten.FlatSpec``); the per-cycle views are sliced from the cycle
segments, so autograd lands the gradient of every leaf in its segment.
A cycle applies its blocks in ``cfg.cycle`` order and returns ``(x,
aux)``, the MoE blocks' load-balance loss summed from 0 (0 for every
other family); the backbone carries ``(x, aux)`` from cycle to cycle, and
the loss adds ``MOE_AUX_COEF * aux / n_cycles`` for MoE archs. The
hybrid's weight-tied shared block is read from the top params by every
cycle; the vlm's ``cross`` layers read ``batch["cross_kv"]`` when the
batch has one.

``remat``: accepted for interface parity and a numerical no-op here. The
reference's sqrt-n remat only trades memory for recompute; at the
slices' depth and sequence length the activations are small next to the
optimizer state, so the port keeps them.

``chunked_loss_vjp`` is the same forward with the graph cut at K chunk
boundaries of the cycle stack, so the backward can run (and emit each
chunk's cycle gradients) one chunk at a time.
"""

from __future__ import annotations

import torch

from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rk
from repro_torch.models.common import ArchConfig, tree_from_paths, tree_map
from repro_torch.models.flatten import FlatSpec, chunk_plan
from repro_torch.models.layers import (attention_block, embed_lookup,
                                       lm_loss, mlp_block,
                                       parallel_attn_mlp_block, rmsnorm)

MOE_AUX_COEF = 0.01


def _apply_cycle(cfg: ArchConfig, cyc_p: dict, shared_p: dict | None,
                 x: torch.Tensor, pos: torch.Tensor,
                 cross_kv: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply one cycle of blocks. Returns (x, the cycle's MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    occ: dict[str, int] = {}
    for kind in cfg.cycle:
        j = occ.get(kind, 0)
        occ[kind] = j + 1
        if kind == "shared_attn":
            x = attention_block(shared_p, cfg, x, pos)
            x = mlp_block(shared_p["mlp"], cfg, x)
            continue
        p = tree_map(lambda a: a[j], cyc_p[kind])
        if kind == "attn":
            if cfg.parallel_block:
                x = parallel_attn_mlp_block(p, cfg, x, pos)
            else:
                x = attention_block(p, cfg, x, pos)
                x = mlp_block(p["mlp"], cfg, x)
        elif kind == "cross":
            x = attention_block(p, cfg, x, pos, cross_kv=cross_kv)
            x = mlp_block(p["mlp"], cfg, x)
        elif kind == "moe":
            x = attention_block(p, cfg, x, pos)
            x, a = moe_lib.moe_block(p["moe"], cfg, x)
            aux = aux + a
        elif kind == "rwkv":
            x = rk.rwkv_block(p, cfg, x)
        elif kind == "mamba":
            x = mb.mamba_block(p, cfg, x)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
    return x, aux


def _backbone(cfg: ArchConfig, fs: FlatSpec, segs: dict,
              tokens: torch.Tensor, pos: torch.Tensor, dtype: torch.dtype,
              cross_kv: torch.Tensor | None
              ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Embed -> cycles -> final norm. Returns (hidden, aux, top params)."""
    top = fs.top_params(segs["top_s"], segs["top_r"], dtype)
    x = embed_lookup(top["embed"], tokens, dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cs, cr = segs["cycles_s"], segs["cycles_r"]
    for c in range(fs.n_cycles):
        x, a = _apply_cycle(cfg, fs.cycle_params(cs[c], cr[c], dtype),
                            top.get("shared_attn"), x, pos, cross_kv)
        aux = aux + a
    return rmsnorm(x, top["final_norm"], cfg.norm_eps), aux, top


def _head_w(cfg: ArchConfig, top: dict) -> torch.Tensor:
    return top["embed"].T if cfg.tie_embeddings else top["head"]


def _loss_head(cfg: ArchConfig, hid: torch.Tensor, aux: torch.Tensor,
               top: dict, labels: torch.Tensor) -> torch.Tensor:
    """Final-norm'd hidden -> CE loss (+ MoE aux): the shared tail of
    ``loss_fn`` and the chunked epilogue."""
    loss = lm_loss(hid, _head_w(cfg, top), labels, cfg)
    if cfg.n_experts:
        loss = loss + MOE_AUX_COEF * aux / max(1, cfg.n_cycles)
    return loss


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


def loss_fn(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch: dict, *,
            dtype: torch.dtype = torch.float32,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token CE (+ MoE aux). batch: tokens/labels (B, S), and
    optionally cross_kv (B, n_cross_tokens, d_model)."""
    del remat  # see module docstring
    tokens = batch["tokens"]
    hid, aux, top = _backbone(cfg, fs, segs, tokens, _positions(tokens),
                              dtype, batch.get("cross_kv"))
    return _loss_head(cfg, hid, aux, top, batch["labels"])


def chunked_loss_vjp(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch: dict,
                     *, chunks: int, dtype: torch.dtype = torch.float32,
                     remat: bool = True):
    """Training forward with the cycle stack cut into K autograd chunks.

    Port of ``repro/models/model.py:chunked_loss_vjp``. The forward runs
    now, as K + 2 graphs: the embed prologue, one per chunk of cycles
    (``flatten.chunk_plan``) and the final-norm + loss epilogue. The carry
    between stages is ``(x, aux)``, as the reference's ``chunk_fn`` and
    ``epilogue`` carry it. Each chunk's input ``x`` is
    ``detach().requires_grad_()`` of the previous stage's output, and each
    chunk's rows ``cycles_s[a:b]`` / ``cycles_r[a:b]`` are leaves of their
    own, so a chunk's ``torch.autograd.grad`` yields its cycle gradients
    and the carry's cotangent and nothing else. The aux value runs on
    from chunk to chunk (the same sums in the same order as ``loss_fn``);
    its cotangent is the epilogue's d loss / d aux in every chunk (aux is
    a plain sum), so for MoE archs each chunk's aux output takes that
    cotangent beside its ``x`` output's.

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

    The hybrid's shared block is read by every cycle. So that its gradient
    is summed in the monolithic backward's order (the cycles' terms in
    reverse cycle order, one after another), each cycle reads it through
    leaves of its own, and a chunk's step adds its cycles' terms into the
    top gradient one cycle at a time, last cycle first. The other top
    coordinates receive at most two terms (tied embeddings: the lookup
    and the head), whose sum is exact in any order. So the gradients are
    the monolithic backward's, bit for bit.

    A stage that reads no top parameter gives ``None`` for them
    (``allow_unused``), and nothing is added: no zero tensor the size of
    ``top_s`` is made for it. Each stage's graph is freed by its backward.
    """
    del remat  # see module docstring
    tokens = batch["tokens"]
    pos = _positions(tokens)
    cross_kv = batch.get("cross_kv")
    bounds = chunk_plan(fs.n_cycles, chunks)
    K = len(bounds)
    moe = bool(cfg.n_experts)
    ts = segs["top_s"].detach().requires_grad_()
    tr = segs["top_r"].detach().requires_grad_()
    shared = [l for l in fs.top_leaves if l.path[0] == "shared_attn"]

    def shared_leaves():
        """One cycle's shared block: (leaf, tensor) pairs and the tree."""
        pairs = [(l, (tr if l.rep else ts)[l.offset:l.offset + l.size]
                  .detach().reshape(l.shape).to(dtype).requires_grad_())
                 for l in shared]
        return pairs, (tree_from_paths([(l.path[1:], v) for l, v in pairs])
                       if pairs else None)

    stages = []   # per chunk: (x in, (x out, aux out), cs, cr, shared)
    with torch.enable_grad():
        top = fs.top_params(ts, tr, dtype)
        pro_out = embed_lookup(top["embed"], tokens, dtype)
        x = pro_out
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for a, b in bounds:
            x_in = x.detach().requires_grad_()
            vs = segs["cycles_s"][a:b].detach().requires_grad_()
            vr = segs["cycles_r"][a:b].detach().requires_grad_()
            y, cyc_shared = x_in, []
            aux = aux.detach()
            for c in range(b - a):
                pairs, shared_p = shared_leaves()
                cyc_shared.append(pairs)
                y, a_c = _apply_cycle(
                    cfg, fs.cycle_params(vs[c], vr[c], dtype), shared_p, y,
                    pos, cross_kv)
                aux = aux + a_c
            stages.append((x_in, (y, aux), vs, vr, cyc_shared))
            x = y
        epi_in = x.detach().requires_grad_()
        epi_aux = aux.detach().requires_grad_(moe)
        top = fs.top_params(ts, tr, dtype)
        hid = rmsnorm(epi_in, top["final_norm"], cfg.norm_eps)
        loss = _loss_head(cfg, hid, epi_aux, top, batch["labels"])
    del top, hid, x, aux

    st: dict = {"d_ts": None, "d_tr": None}

    def acc_top(d_ts, d_tr):
        for name, g in (("d_ts", d_ts), ("d_tr", d_tr)):
            if g is not None:
                st[name] = g if st[name] is None else st[name].add_(g)

    def acc_shared(pairs, grads):
        for (l, v), g in zip(pairs, grads):
            name = "d_tr" if l.rep else "d_ts"
            if st[name] is None:
                st[name] = torch.zeros_like(tr if l.rep else ts)
            if g is not None:
                st[name][l.offset:l.offset + l.size].add_(g.reshape(-1))

    def grad(out, inputs, cot):
        return torch.autograd.grad(out, inputs, grad_outputs=cot,
                                   allow_unused=True)

    def make_step(j: int):
        c = K - 1 - j
        a, b = bounds[c]

        def run():
            if j == 0:
                if moe:
                    st["d_carry"], st["d_aux"], d_ts, d_tr = grad(
                        loss, (epi_in, epi_aux, ts, tr), torch.ones_like(loss))
                else:
                    st["d_carry"], d_ts, d_tr = grad(
                        loss, (epi_in, ts, tr), torch.ones_like(loss))
                acc_top(d_ts, d_tr)
            x_in, (y, aux_out), vs, vr, cyc_shared = stages[c]
            stages[c] = None
            outs, cots = (y,), (st.pop("d_carry"),)
            if moe:
                outs, cots = (y, aux_out), cots + (st["d_aux"],)
            flat_shared = [v for pairs in cyc_shared for _, v in pairs]
            d_carry, d_cs, d_cr, d_ts, d_tr, *d_sh = grad(
                outs, (x_in, vs, vr, ts, tr, *flat_shared), cots)
            acc_top(d_ts, d_tr)
            n = len(shared)
            for i in reversed(range(len(cyc_shared))):
                acc_shared(cyc_shared[i], d_sh[i * n:(i + 1) * n])
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
