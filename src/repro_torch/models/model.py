"""Forward for every family: embed -> cycles -> norm -> CE for training,
and the serving targets ``prefill_fn`` / ``decode_fn`` over a KV /
recurrent-state cache.

Port of ``repro/models/model.py`` (``_apply_cycle``, ``_backbone``,
``loss_fn``, ``chunked_loss_vjp``, ``prefill_fn``, ``decode_fn`` and the
cache helpers). Parameters arrive as flat segments
(``flatten.FlatSpec``); the per-cycle views are sliced from the cycle
segments, so autograd lands the gradient of every leaf in its segment.
The ops that make those views run under a ``params/views`` span (cat
``detail``, ``obs/trace.py``): under ``torch.profiler`` their backward
nodes (``SelectBackward0``, ``SliceBackward0``, ...) carry the same
sequence numbers, and their ranges are the segment gradients' assembly.
A cycle applies its blocks in ``cfg.cycle`` order and returns ``(x,
aux)``, the MoE blocks' load-balance loss summed from 0 (0 for every
other family); the backbone carries ``(x, aux)`` from cycle to cycle, and
the loss adds ``MOE_AUX_COEF * aux / n_cycles`` for MoE archs. The
hybrid's weight-tied shared block is read from the top params by every
cycle; the vlm's ``cross`` layers read ``batch["cross_kv"]`` when the
batch has one.

Tensor parallelism (``ctx``, a ``common.ShardCtx``; None is tp = 1):
the segments arrive in the *use* layout of the reference's gathers
(``core.gs_sgd._gather_closures``): the model-sharded segments rank
-stacked (``top_s`` (tp, f), ``cycles_s`` (tp, n, f)), the replicated
ones gathered whole and unranked (``top_r`` (f,), ``cycles_r`` (n, f)).
Activations are then rank-stacked (tp, B, S, d); the loss is a (tp,)
tensor, every rank's equal; ``prefill_fn`` returns each rank's vocab
shard of the logits (tp, B, V_loc) and ``decode_fn`` every rank's (equal)
ids (tp, B). The cache holds every rank's heads in global order
(``init_cache(..., ctx=)``). ``chunked_loss_vjp`` takes the same
``ctx``, and the storage layout with the gathers (its docstring).

``remat`` (training only): the reference's cycle remat. Each cycle runs
as a recomputed region (``models.remat.remat_call``), so its
backward recomputes the cycle's activations from the carry; and with n
cycles and n2 = isqrt(n) >= 2 the cycles run in the sqrt-n two-level
structure of the reference's ``_scan_cycles``: n1 = n // n2 outer groups
of n2 cycles, each group checkpointed as a whole around its cycles'
checkpoints, then the n - n1 * n2 tail cycles one by one. The backward
then holds about n1 + n2 carries (B, S, d) and one cycle's activations,
not n cycles' activations. ``loss_fn`` and each chunk of
``chunked_loss_vjp`` use it, as the reference's ``_backbone`` and
``chunk_fn`` do. It trades memory for recompute and changes no value:
the recomputed forward is the same ops on the same inputs. Collectives
inside a checkpointed cycle (tp > 1 on a mesh) run again in its
recompute, as XLA's remat runs them.

``chunked_loss_vjp`` is the same forward with the graph cut at K chunk
boundaries of the cycle stack, so the backward can run (and emit each
chunk's cycle gradients) one chunk at a time.

The cache (``init_cache``) is a dict by block kind of stacked leaves,
``(n_cycles, count in the cycle, B, ...)``: K/V ``(.., B, T, Hkv, hd)``
for the attention, MoE and shared kinds, the recurrent state for rwkv
and mamba, nothing for the vlm's cross layers. The serve forward writes
each block's slice of it IN PLACE (views ``cache[kind][leaf][c, j]``)
and returns the same dict, as the reference's serve body updates its
scan carry in place: no cache-sized buffer is built per cycle or step.
A caller that needs the cache it passed in unchanged passes a copy.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rk
from repro_torch.models.common import (ArchConfig, ShardCtx, head_geometry,
                                       tree_from_paths, tree_map)
from repro_torch.models.flatten import FlatSpec, chunk_plan
from repro_torch.models.layers import (attention_block, embed_lookup,
                                       lm_logits, lm_loss, mlp_block,
                                       parallel_attn_mlp_block, rmsnorm,
                                       sharded_argmax)
from repro_torch.models.remat import remat_call
from repro_torch.obs import trace as obtrace

MOE_AUX_COEF = 0.01


def _kind_counts(cfg: ArchConfig) -> dict[str, int]:
    counts: dict[str, int] = {}
    for kind in cfg.cycle:
        if kind != "shared_attn":
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def _write_state(view: dict, new: dict) -> None:
    """A recurrent block's new state into its cache slice, in place."""
    for name, leaf in new.items():
        view[name].copy_(leaf)


def _apply_cycle(cfg: ArchConfig, cyc_p: dict, shared_p: dict | None,
                 x: torch.Tensor, pos: torch.Tensor,
                 cross_kv: torch.Tensor | None, mode: str = "train",
                 cache: dict | None = None, kv_len=None,
                 ctx: ShardCtx | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply one cycle of blocks. Returns (x, the cycle's MoE aux loss).

    ``cache`` (serving): this cycle's slice of the cache, ``{kind: {leaf:
    (count, B, ...)}}``; block j of a kind reads and writes its row j in
    place (the reference's ``sub`` / ``put``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    occ: dict[str, int] = {}

    def sub(kind: str, j: int):
        return None if cache is None else tree_map(lambda a: a[j],
                                                   cache[kind])

    serve = mode != "train"
    for kind in cfg.cycle:
        j = occ.get(kind, 0)
        occ[kind] = j + 1
        if kind == "shared_attn":
            if serve:
                x, _ = attention_block(shared_p, cfg, x, pos, mode=mode,
                                       cache=sub(kind, j), kv_len=kv_len,
                                       ctx=ctx)
            else:
                x = attention_block(shared_p, cfg, x, pos, ctx=ctx)
            x = mlp_block(shared_p["mlp"], cfg, x, ctx)
            continue
        p = tree_map(lambda a: a[j], cyc_p[kind])
        if kind == "attn":
            blk = (parallel_attn_mlp_block if cfg.parallel_block
                   else attention_block)
            if serve:
                x, _ = blk(p, cfg, x, pos, mode=mode, cache=sub(kind, j),
                           kv_len=kv_len, ctx=ctx)
            else:
                x = blk(p, cfg, x, pos, ctx=ctx)
            if not cfg.parallel_block:
                x = mlp_block(p["mlp"], cfg, x, ctx)
        elif kind == "cross":
            if serve and cross_kv is None:
                raise ValueError("the vlm's cross layers serve only with "
                                 "cross_kv (its static patch embeddings)")
            x = attention_block(p, cfg, x, pos, cross_kv=cross_kv,
                                mode=mode, ctx=ctx)
            x = x[0] if serve else x
            x = mlp_block(p["mlp"], cfg, x, ctx)
        elif kind == "moe":
            if serve:
                x, _ = attention_block(p, cfg, x, pos, mode=mode,
                                       cache=sub(kind, j), kv_len=kv_len,
                                       ctx=ctx)
            else:
                x = attention_block(p, cfg, x, pos, ctx=ctx)
            x, a = moe_lib.moe_block(p["moe"], cfg, x, ctx)
            aux = aux + a
        elif kind == "rwkv":
            st = sub(kind, j)
            if st is None:
                x = rk.rwkv_block(p, cfg, x, ctx=ctx)
            else:
                x, new = rk.rwkv_block(p, cfg, x, state=st, ctx=ctx)
                _write_state(st, new)
        elif kind == "mamba":
            st = sub(kind, j)
            if st is None:
                x = mb.mamba_block(p, cfg, x, ctx=ctx)
            else:
                x, new = mb.mamba_block(p, cfg, x, state=st, ctx=ctx)
                _write_state(st, new)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
    return x, aux


def scan_cycles(cyc, n: int, x: torch.Tensor, aux: torch.Tensor,
                remat: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Run cycles 0..n-1 of ``cyc(c, x, aux) -> (x, aux)`` on the carry.

    With ``remat`` every cycle is checkpointed and, when n2 = isqrt(n) >=
    2, the cycles run in the sqrt-n two-level structure of the
    reference's ``_scan_cycles``: n1 = n // n2 checkpointed groups of n2
    checkpointed cycles, then the tail (module docstring)."""
    if not remat:
        for c in range(n):
            x, aux = cyc(c, x, aux)
        return x, aux

    def one(c):
        return lambda x, aux: cyc(c, x, aux)

    def group(a, b):
        def run(x, aux):
            for c in range(a, b):
                x, aux = remat_call(one(c), x, aux)
            return x, aux
        return run

    n2 = math.isqrt(n)
    done = 0
    if n2 >= 2:
        for g in range(n // n2):
            x, aux = remat_call(group(g * n2, (g + 1) * n2), x, aux)
        done = n // n2 * n2
    return group(done, n)(x, aux)


def _backbone(cfg: ArchConfig, fs: FlatSpec, segs: dict,
              tokens: torch.Tensor, pos: torch.Tensor, dtype: torch.dtype,
              cross_kv: torch.Tensor | None, mode: str = "train",
              cache: dict | None = None, kv_len=None,
              ctx: ShardCtx | None = None, remat: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Embed -> cycles -> final norm. Returns (hidden, aux, top params).

    With ``cache`` each cycle c works on the views ``cache[kind][leaf][c]``
    (the reference's serve body, whose carry is updated in place).
    ``remat``: the cycle remat (training; module docstring)."""
    with obtrace.current().span("params/views", cat="detail"):
        top = fs.top_params(segs["top_s"], segs["top_r"], dtype)
    x = embed_lookup(top["embed"], tokens, dtype, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cs, cr = segs["cycles_s"], segs["cycles_r"]
    ranked = ctx is not None and ctx.ranked

    def cyc(c, x, aux):
        cyc_cache = (None if cache is None
                     else tree_map(lambda a: a[c], cache))
        with obtrace.current().span("params/views", cat="detail"):
            p = fs.cycle_params(cs[:, c] if ranked else cs[c], cr[c], dtype)
        x, a = _apply_cycle(cfg, p, top.get("shared_attn"), x, pos,
                            cross_kv, mode, cyc_cache, kv_len, ctx)
        return x, aux + a

    x, aux = scan_cycles(cyc, fs.n_cycles, x, aux,
                         remat and mode == "train")
    return rmsnorm(x, top["final_norm"], cfg.norm_eps), aux, top


def _head_w(cfg: ArchConfig, top: dict) -> torch.Tensor:
    return top["embed"].mT if cfg.tie_embeddings else top["head"]


def _loss_head(cfg: ArchConfig, hid: torch.Tensor, aux: torch.Tensor,
               top: dict, labels: torch.Tensor,
               ctx: ShardCtx | None = None) -> torch.Tensor:
    """Final-norm'd hidden -> CE loss (+ MoE aux): the shared tail of
    ``loss_fn`` and the chunked epilogue."""
    loss = lm_loss(hid, _head_w(cfg, top), labels, cfg, ctx)
    if cfg.n_experts:
        loss = loss + MOE_AUX_COEF * aux / max(1, cfg.n_cycles)
    return loss


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


def loss_fn(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch: dict, *,
            dtype: torch.dtype = torch.float32,
            remat: bool = True, ctx: ShardCtx | None = None) -> torch.Tensor:
    """Mean next-token CE (+ MoE aux). batch: tokens/labels (B, S), and
    optionally cross_kv (B, n_cross_tokens, d_model). At tp > 1 (``ctx``)
    a (tp,) tensor: every rank's copy of the same loss. ``remat``: the
    cycle remat (module docstring)."""
    tokens = batch["tokens"]
    hid, aux, top = _backbone(cfg, fs, segs, tokens, _positions(tokens),
                              dtype, batch.get("cross_kv"), ctx=ctx,
                              remat=remat)
    return _loss_head(cfg, hid, aux, top, batch["labels"], ctx)


def chunked_loss_vjp(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch,
                     *, chunks: int, dtype: torch.dtype = torch.float32,
                     remat: bool = True, ctx: ShardCtx | None = None,
                     gathers=None, grad_seed: float = 1.0):
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

    Sharded layouts (``ctx``, ``gathers``, ``grad_seed``, as the
    reference's): without ``gathers`` ``segs`` is the use layout
    ``loss_fn`` reads (rank-stacked at tp > 1). With ``gathers`` =
    ``(gather, scatter)`` of ``core.gs_sgd`` (``_gather_closures`` or, on
    a process mesh, ``_mesh_gather_closures``), ``segs`` is one gather
    group's storage, every segment (tp, n, *local), and ``batch`` a list
    of the group's n workers' batches, which share the gathered storage
    (a pod's ``data`` workers in 'fsdp'; n = 1 in 'dp'). The top segments
    are gathered once, in a stage of their own: every stage of every
    worker reads those leaves, their cotangents accumulate on them (each
    worker's in stage order, then the workers' added in worker order, as
    the monolithic backward's ``.grad`` adds them), and the gather's
    transpose (``scatter``: the reference's psum_scatter, a
    reduce-scatter on a mesh) runs once, in ``top_grads``. So a K-chunk
    step does not multiply the top segments' collectives by K + 2. Each
    chunk gathers its own cycle rows, and its backward step scatters
    their gradient (the group's workers' summed in worker order) at
    once: a step returns its cycle gradients in the storage layout, (tp,
    n, b-a, *local), complete at its emission event. ``grad_seed`` is
    the loss cotangent (the caller's 1/tp seed; every rank's copy of the
    (tp,) loss takes it, as ``(loss / tp).sum().backward()`` gives it).

    Returns ``(loss, bwd_steps, top_grads)``, the reference's contract:

      loss       -- ``loss_fn``'s value, detached (unseeded): 0-dim, (tp,)
                    when ranked, or with a list of batches the workers'
                    losses stacked.
      bwd_steps  -- K thunks to call STRICTLY in order. Step j runs chunk
                    K-1-j's backward and returns ``((a, b), d_cs, d_cr)``:
                    the chunk's cycle rows and its (b-a, f) gradients
                    (the storage layout with ``gathers``). Step 0 first
                    runs the epilogue's backward; the last step also runs
                    the prologue's.
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
    the monolithic backward's, bit for bit, on every layout: a rank
    sum (a replicated leaf read by every rank) is inside one stage's
    node, as in the monolithic graph, and the cycle rows of different
    cycles are disjoint.

    A stage that reads no top parameter gives ``None`` for them
    (``allow_unused``), and nothing is added: no zero tensor the size of
    ``top_s`` is made for it. Each stage's graph is freed by its backward.

    ``remat``: each chunk runs its cycles in the cycle remat's structure
    (``scan_cycles`` over the chunk's range, as the reference's
    ``chunk_fn``), so a chunk's graph holds its groups' carries.
    """
    group = isinstance(batch, (list, tuple))
    batches = list(batch) if group else [batch]
    gather, scatter = gathers or (None, None)
    ranked = ctx is not None and ctx.ranked
    bounds = chunk_plan(fs.n_cycles, chunks)
    K = len(bounds)
    moe = bool(cfg.n_experts)
    if gather is None:
        top_use = {k: segs[k] for k in ("top_s", "top_r")}
    else:
        top_use = gather({k: segs[k] for k in ("top_s", "top_r")})
    ts = top_use["top_s"].detach().requires_grad_()
    tr = top_use["top_r"].detach().requires_grad_()
    del top_use
    shared = [l for l in fs.top_leaves if l.path[0] == "shared_attn"]

    def cycle_rows(a: int, b: int) -> tuple:
        """The chunk's cycle rows as leaves of the use layout."""
        if gather is None:
            cs, cr = segs["cycles_s"], segs["cycles_r"]
            rows = {"cycles_s": cs[:, a:b] if ranked else cs[a:b],
                    "cycles_r": cr[a:b]}
        else:
            rows = gather({k: segs[k][:, :, a:b]
                           for k in ("cycles_s", "cycles_r")})
        return (rows["cycles_s"].detach().requires_grad_(),
                rows["cycles_r"].detach().requires_grad_())

    def shared_slot(l, seg):
        """A shared-block leaf's coordinates in its top segment (a view;
        every rank's at tp > 1, as ``FlatSpec.top_params`` reads them)."""
        if l.rep or seg.ndim == 1:
            return seg[l.offset:l.offset + l.size]
        return seg[:, l.offset:l.offset + l.size]

    def shared_leaves():
        """One cycle's shared block: (leaf, tensor) pairs and the tree."""
        pairs = []
        for l in shared:
            slot = shared_slot(l, tr if l.rep else ts)
            pairs.append((l, slot.detach().reshape(slot.shape[:-1] + l.shape)
                          .to(dtype).requires_grad_()))
        return pairs, (tree_from_paths([(l.path[1:], v) for l, v in pairs])
                       if pairs else None)

    chunk_leaves = [cycle_rows(a, b) for a, b in bounds]
    workers = []   # per worker: its stages, epilogue and loss
    with torch.enable_grad():
        for wb in batches:
            tokens = wb["tokens"]
            pos = _positions(tokens)
            cross_kv = wb.get("cross_kv")
            with obtrace.current().span("params/views", cat="detail"):
                top = fs.top_params(ts, tr, dtype)
            pro_out = embed_lookup(top["embed"], tokens, dtype, ctx)
            x = pro_out
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            stages = []   # per chunk: (x in, (x out, aux out), shared)
            for (a, b), (vs, vr) in zip(bounds, chunk_leaves):
                x_in = x.detach().requires_grad_()
                aux = aux.detach()
                leaves = [shared_leaves() for _ in range(b - a)]

                def cyc(c, y, aux, vs=vs, vr=vr, leaves=leaves, pos=pos,
                        cross_kv=cross_kv):
                    with obtrace.current().span("params/views",
                                                cat="detail"):
                        p = fs.cycle_params(vs[:, c] if ranked else vs[c],
                                            vr[c], dtype)
                    y, a_c = _apply_cycle(cfg, p, leaves[c][1], y, pos,
                                          cross_kv, ctx=ctx)
                    return y, aux + a_c

                y, aux = scan_cycles(cyc, b - a, x_in, aux, remat)
                stages.append((x_in, (y, aux), [p for p, _ in leaves]))
                x = y
            epi_in = x.detach().requires_grad_()
            epi_aux = aux.detach().requires_grad_(moe)
            with obtrace.current().span("params/views", cat="detail"):
                top = fs.top_params(ts, tr, dtype)
            hid = rmsnorm(epi_in, top["final_norm"], cfg.norm_eps)
            loss = _loss_head(cfg, hid, epi_aux, top, wb["labels"], ctx)
            workers.append({"stages": stages, "pro_out": pro_out,
                            "epi_in": epi_in, "epi_aux": epi_aux,
                            "loss": loss, "d_ts": None, "d_tr": None})
            del top, hid, x, aux, pro_out, loss

    def acc_top(st, d_ts, d_tr):
        for name, g in (("d_ts", d_ts), ("d_tr", d_tr)):
            if g is not None:
                st[name] = g if st[name] is None else st[name].add_(g)

    def acc_shared(st, pairs, grads):
        for (l, v), g in zip(pairs, grads):
            name = "d_tr" if l.rep else "d_ts"
            if st[name] is None:
                st[name] = torch.zeros_like(tr if l.rep else ts)
            if g is not None:
                slot = shared_slot(l, st[name])
                slot.add_(g.reshape(slot.shape))

    def grad(out, inputs, cot):
        return torch.autograd.grad(out, inputs, grad_outputs=cot,
                                   allow_unused=True)

    def run_worker(st, c: int, vs, vr):
        """Chunk c's backward of one worker (the epilogue's first when c is
        the last chunk, the prologue's after chunk 0): its cycle rows'
        gradients."""
        if c == K - 1:
            loss = st.pop("loss")
            seed = torch.full_like(loss, grad_seed)
            if moe:
                st["d_carry"], st["d_aux"], d_ts, d_tr = grad(
                    loss, (st["epi_in"], st["epi_aux"], ts, tr), seed)
            else:
                st["d_carry"], d_ts, d_tr = grad(
                    loss, (st["epi_in"], ts, tr), seed)
            acc_top(st, d_ts, d_tr)
        x_in, (y, aux_out), cyc_shared = st["stages"][c]
        st["stages"][c] = None
        outs, cots = (y,), (st.pop("d_carry"),)
        if moe:
            outs, cots = (y, aux_out), cots + (st["d_aux"],)
        flat_shared = [v for pairs in cyc_shared for _, v in pairs]
        d_carry, d_cs, d_cr, d_ts, d_tr, *d_sh = grad(
            outs, (x_in, vs, vr, ts, tr, *flat_shared), cots)
        acc_top(st, d_ts, d_tr)
        n = len(shared)
        for i in reversed(range(len(cyc_shared))):
            acc_shared(st, cyc_shared[i], d_sh[i * n:(i + 1) * n])
        if c == 0:  # embed backward: the top segments' last piece
            acc_top(st, *grad(st.pop("pro_out"), (ts, tr), d_carry))
        else:
            st["d_carry"] = d_carry
        return d_cs, d_cr

    def worker_sum(parts, like):
        """The group's workers' gradients of one leaf, added in worker
        order (zeros for a leaf no worker reads)."""
        parts = [p for p in parts if p is not None]
        if not parts:
            return torch.zeros_like(like)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def to_storage(use: dict) -> tuple:
        if scatter is None:
            return tuple(use.values())
        out = scatter(use, len(batches))
        return tuple(out[k] for k in use)

    def make_step(j: int):
        c = K - 1 - j
        a, b = bounds[c]

        def run():
            vs, vr = chunk_leaves[c]
            chunk_leaves[c] = None
            grads = [run_worker(st, c, vs, vr) for st in workers]
            d_cs, d_cr = to_storage({
                "cycles_s": worker_sum([g[0] for g in grads], vs),
                "cycles_r": worker_sum([g[1] for g in grads], vr)})
            return (a, b), d_cs, d_cr

        return run

    def top_grads():
        d_ts = worker_sum([st.pop("d_ts") for st in workers], ts)
        d_tr = worker_sum([st.pop("d_tr") for st in workers], tr)
        return to_storage({"top_s": d_ts, "top_r": d_tr})

    losses = [w["loss"].detach() for w in workers]
    loss = torch.stack(losses) if group else losses[0]
    return loss, [make_step(j) for j in range(K)], top_grads


# ---------------------------------------------------------------------------
# Serving targets
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_fn(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch: dict,
               cache: dict, *, dtype: torch.dtype = torch.float32,
               ctx: ShardCtx | None = None) -> tuple[torch.Tensor, dict]:
    """Prompt forward; fills ``cache`` (in place) from position 0.
    batch: tokens (B, S) [cross_kv]. Returns (last-token logits (B,
    V_pad) f32, or each rank's vocab shard (tp, B, V_loc) at tp > 1, the
    cache)."""
    tokens = batch["tokens"]
    hid, _, top = _backbone(cfg, fs, segs, tokens, _positions(tokens),
                            dtype, batch.get("cross_kv"), "prefill", cache,
                            0, ctx)
    logits = lm_logits(hid[..., -1:, :], _head_w(cfg, top), cfg, ctx)
    return logits[..., 0, :], cache


@torch.no_grad()
def decode_fn(cfg: ArchConfig, fs: FlatSpec, segs: dict,
              tokens: torch.Tensor, kv_len, cache: dict, *,
              cross_kv: torch.Tensor | None = None,
              dtype: torch.dtype = torch.float32,
              ctx: ShardCtx | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) at position ``kv_len`` -> (next-token
    ids (B,) int32, every rank's (equal) copy (tp, B) at tp > 1, the
    cache, updated in place).

    ``kv_len`` is the valid cache length BEFORE this token: an int or
    0-dim tensor (the whole batch at one position) or a (B,) tensor (each
    row at its own position: continuous batching)."""
    B, S = tokens.shape
    kl = torch.as_tensor(kv_len, device=tokens.device)
    pos = (kl[:, None] if kl.ndim else kl).expand(B, S)
    hid, _, top = _backbone(cfg, fs, segs, tokens, pos, dtype, cross_kv,
                            "decode", cache, kl, ctx)
    logits = lm_logits(hid, _head_w(cfg, top), cfg, ctx)
    return sharded_argmax(logits[..., 0, :], ctx), cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, b_loc: int, t_cache: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu",
               ctx: ShardCtx | None = None) -> dict:
    """Zeroed cache, stacked ``(n_cycles, count, ...)`` leaves.

    Attention/MoE kinds and the hybrid's shared block (count 1) get KV
    caches ``(n, cnt, b_loc, t_cache, Hkv, hd)`` in ``dtype``; rwkv and
    mamba their recurrent states (f32 but mamba's conv tail); the vlm's
    cross blocks none. ``device="meta"`` gives shapes and dtypes with no
    allocation (``cache_shapes``). At tp > 1 (``ctx``) Hkv is every
    rank's KV heads side by side (tp x the heads a rank stores, one each
    for replicated KV), and the states hold every rank's heads; on a
    process mesh (``ctx.model``) this process's rank's only."""
    n = cfg.n_cycles
    tp = ctx.tp if ctx is not None else 1
    nr = ctx.lead if ctx is not None else 1   # ranks held: tp, or 1 a process
    g = head_geometry(cfg, tp)
    nkv = nr * (1 if g.kv_replicated else g.nkv_loc)

    def stack(cnt, leaf):
        return torch.zeros((n, cnt) + tuple(leaf.shape), dtype=leaf.dtype,
                           device=device)

    def kv(cnt):
        shape = (n, cnt, b_loc, t_cache, nkv, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache: dict = {}
    for kind, cnt in _kind_counts(cfg).items():
        if kind in ("attn", "moe"):
            cache[kind] = kv(cnt)
        elif kind == "rwkv":
            st = rk.init_rwkv_state(cfg, b_loc, device="meta", tp=tp,
                                    ranks=nr)
            cache[kind] = tree_map(lambda a: stack(cnt, a), st)
        elif kind == "mamba":
            st = mb.init_mamba_state(cfg, b_loc, dtype, device="meta", tp=tp,
                                     ranks=nr)
            cache[kind] = tree_map(lambda a: stack(cnt, a), st)
        # 'cross': no cache
    if "shared_attn" in cfg.cycle:
        cache["shared_attn"] = kv(1)
    return cache


def cache_shapes(cfg: ArchConfig, b_loc: int, t_cache: int,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """The cache on the meta device: shapes and dtypes, no allocation."""
    return init_cache(cfg, b_loc, t_cache, dtype, device="meta")


# Cache kinds whose leaves carry a time axis (axis 3 of the stacked
# (n, cnt, B, T, nkv, hd) layout) and are therefore pageable; rwkv/mamba
# kinds hold fixed-size recurrent state with batch axis 2 and no time axis.
KV_CACHE_KINDS = ("attn", "moe", "shared_attn")


def split_cache(cache: dict) -> tuple[dict, dict]:
    """Split a cache into (kv_kinds, state_kinds) sub-dicts sharing the
    input's leaves (no copy). The serve layer pages only the KV kinds."""
    kv = {k: v for k, v in cache.items() if k in KV_CACHE_KINDS}
    state = {k: v for k, v in cache.items() if k not in KV_CACHE_KINDS}
    return kv, state


def merge_cache(kv: dict, state: dict) -> dict:
    """Inverse of :func:`split_cache`."""
    out = dict(kv)
    out.update(state)
    return out
