"""Analytic per-device FLOP / HBM-byte / collective-byte model per cell.

Port of ``benchmarks/comm_model.py``: configuration algebra over the
port's own ``configs``, ``models`` and ``core.gs_sgd``, held field for
field to the reference's numbers (``tests/test_torch_comm_model.py``).
The model keeps the reference's own assumptions (the remat recompute is
counted as +1x forward, 20 flops a coordinate and row for the sketch);
the port's dry-run (``launch/dryrun.py``) counts the FLOPs it executes
instead, and ``bench/roofline.py`` prints the two side by side.

The reference made the model analytic because a compiled program's cost
analysis counts a loop body once; here every loop's trip count is
explicit in the algebra, and the model is cross-checked against
MODEL_FLOPS = 6·N·D.

All byte counts are per device per step; collective bytes use the ring
model (all-reduce 2(P-1)/P, all-gather/psum_scatter (P-1)/P of payload)
and are bucketed by mesh axis so the roofline can price the pod axis
(the slow cross-pod link) apart from the in-pod axes.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs import TRAIN_OVERRIDES
from repro_torch.configs.shapes import SHAPES, ShapeCase
from repro_torch.core.gs_sgd import MeshAxes, local_seg_shapes
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv as rk
from repro_torch.models.common import (ArchConfig, head_geometry,
                                       padded_experts, padded_vocab)
from repro_torch.models.flatten import make_flat_spec

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CellModel:
    flops: float                 # per device per step
    hbm_bytes: float             # per device per step
    coll_bytes: dict             # axis -> per-device wire bytes
    model_flops: float           # 6*N(_active)*D useful flops per device
    params_local: int            # per-device stored parameter count
    notes: list

    @property
    def total_coll(self) -> float:
        return sum(self.coll_bytes.values())


def _ring(nbytes: float, p: int) -> float:
    return 2.0 * (p - 1) / p * nbytes if p > 1 else 0.0


def _gather(nbytes: float, p: int) -> float:
    """all-gather / psum_scatter wire bytes for a FULL payload of nbytes."""
    return (p - 1) / p * nbytes if p > 1 else 0.0


def _attn_flops(cfg: ArchConfig, tokens: int, kv_len: int, tp: int) -> float:
    """Self-attention matmul flops per device (fwd), grouped GQA."""
    g = head_geometry(cfg, tp)
    hd = cfg.hd
    # scores + AV: 2 * 2 * tokens * kv_len * (heads_loc * hd)
    return 4.0 * tokens * kv_len * g.nq_loc * hd


def _proj_flops_per_layer(cfg: ArchConfig, tp: int) -> float:
    """Per-token fwd matmul flops of one cycle-layer's projections (local)."""
    g = head_geometry(cfg, tp)
    d, hd = cfg.d_model, cfg.hd
    kv_cols = (1 if g.kv_replicated else g.nkv_loc) * hd
    f = 0.0
    if cfg.block in ("attn", "moe") or cfg.family in ("vlm",):
        f += 2.0 * d * (g.nq_loc * hd)            # wq
        f += 2.0 * d * kv_cols * 2                # wk, wv
        f += 2.0 * (g.nq_loc * hd) * d            # wo
    if cfg.block == "attn" or cfg.family == "vlm":
        ff = _pad(cfg.d_ff, tp) // tp
        f += 2.0 * d * ff * 3                     # wg, wu, wo
    if cfg.block == "moe":
        ne_loc = padded_experts(cfg, tp) // tp
        # top-k routed: each token does k experts' FFN; spread over EP ranks
        f += 2.0 * d * padded_experts(cfg, tp)    # router (replicated)
        f += (2.0 * d * cfg.d_ff * 3) * cfg.experts_per_tok / tp * 1.0
    if cfg.block == "rwkv":
        nh, hd_r = rk.rwkv_geometry(cfg, tp)
        dh = nh * hd_r // tp
        f += 2.0 * d * dh * 5 + 2.0 * dh * d      # r,k,v,g,w + out
        ffr = _pad(cfg.d_ff, tp) // tp
        f += 2.0 * d * ffr + 2.0 * ffr * d        # channel mix
    if cfg.block == "mamba":
        nh, hd_m, ns = mb.mamba_geometry(cfg, tp)
        dh = nh * hd_m // tp
        f += 2.0 * d * dh * 2 + 2.0 * dh * d      # x, z, out
        f += 2.0 * d * (nh // tp) * (2 * ns + 1)  # B, C, dt
    return f


def _pad(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _mixer_flops(cfg: ArchConfig, tokens: int, kv_len: int, tp: int,
                 chunk: int = 64) -> float:
    """Sequence-mixing flops per device (fwd) for one layer."""
    if cfg.block == "rwkv":
        nh, hd = rk.rwkv_geometry(cfg, tp)
        # chunked: ~2 * L * (hd k + hd v) per token per head + state update
        return tokens * (nh // tp) * (4.0 * chunk * hd + 4.0 * hd * hd)
    if cfg.block == "mamba":
        nh, hd, ns = mb.mamba_geometry(cfg, tp)
        return tokens * (nh // tp) * (2.0 * chunk * ns + 4.0 * ns * hd)
    return _attn_flops(cfg, tokens, kv_len, tp)


def _cycle_kinds(cfg: ArchConfig):
    return [k for k in cfg.cycle]


def train_cell(cfg: ArchConfig, ma: MeshAxes, dp_mode: str,
               case: ShapeCase | None = None,
               opts: dict | None = None) -> CellModel:
    """opts (perf-iteration knobs; see EXPERIMENTS.md §Perf):
      microbatch        — override the accumulation slice size
      parallel_block    — PaLM parallel attn||mlp (1 psum/layer)
      act_comm_factor   — wire-byte multiplier on activation reductions
                          (0.25 for fp8-on-the-wire)
      compressor        — 'gs-sgd' (default) | 'dense' | None
      sketch            — dict(k=..., rows=..., width=...) override
      gather_passes     — override the fsdp (re)gather pass count
    """
    opts = opts or {}
    case = case or SHAPES["train_4k"]
    notes = []
    ov = dict(TRAIN_OVERRIDES.get(cfg.name, {}))
    ov.update(opts)
    tp, dp = ma.tp, ma.dp_size
    b_loc = max(1, case.global_batch // dp)
    tokens = b_loc * case.seq_len                 # per device per step
    mb_rows = ov.get("microbatch") or max(1, min(b_loc,
                                                 16384 // case.seq_len))
    n_layers = cfg.n_layers + (cfg.n_cycles if "shared_attn" in cfg.cycle
                               else 0)

    # ---- FLOPs ----------------------------------------------------------
    proj = sum(_proj_flops_per_layer(cfg, tp) for _ in range(1)) * n_layers
    fwd = tokens * proj
    fwd += sum(_mixer_flops(cfg, tokens, case.seq_len, tp)
               for _ in range(n_layers))
    if cfg.family == "vlm":  # cross-attn KV over n_cross tokens
        n_cross_layers = cfg.n_layers // cfg.cross_attn_every
        fwd += 4.0 * tokens * cfg.n_cross_tokens * \
            head_geometry(cfg, tp).nq_loc * cfg.hd * n_cross_layers
    vp = padded_vocab(cfg, tp)
    fwd += 2.0 * tokens * cfg.d_model * (vp // tp) * 2  # embed+head
    # bwd = 2x fwd; remat recompute ~ +1x fwd (sqrt-n nested scan)
    flops = fwd * (1.0 + 2.0 + 1.0)
    notes.append(f"remat recompute counted as +1x forward; mb={mb_rows}")

    # sketch compressor flops: O(d * rows) encode + decode + topk ~
    # small; count 20 flops/coord/row
    fs = make_flat_spec(cfg, tp)
    shapes = local_seg_shapes(fs, ma, dp_mode)
    d_local = sum(math.prod(s) for s in shapes.values())
    comp_axes = ma.dp_axes if dp_mode == "dp" else (
        (ma.pod_axis,) if ma.pod_axis else ())
    if comp_axes:
        flops += 20.0 * d_local * 5

    # ---- HBM bytes ------------------------------------------------------
    params_local = d_local
    act_bytes = tokens * cfg.d_model * BF16 * n_layers * 4  # rough activ.
    weight_passes = 3 + 1                                   # fwd+bwd+remat
    hbm = params_local * BF16 * weight_passes * max(
        1, b_loc // mb_rows) + params_local * F32 * 4       # p, m, g, ef
    hbm += act_bytes * 2
    if comp_axes:
        hbm += d_local * F32 * 6  # u, est chunks, residual, pack

    # ---- collective bytes, per axis --------------------------------------
    coll = {"model": 0.0, "data": 0.0, "pod": 0.0}
    n_mb = max(1, b_loc // mb_rows)
    tok_mb = mb_rows * case.seq_len
    # forward psums over model: embed + per-layer row-parallel (+remat x2)
    psum_payload = tok_mb * cfg.d_model * BF16
    psums_per_layer = {"attn": 2, "moe": 2, "rwkv": 2, "mamba": 1}.get(
        cfg.block, 2)
    if ov.get("parallel_block") and cfg.block == "attn":
        psums_per_layer = 1
        notes.append("parallel_block: 1 psum/layer")
    fwd_psums = (1 + psums_per_layer * n_layers) * psum_payload
    ce = 3 * tok_mb * F32
    act_f = ov.get("act_comm_factor", 1.0)
    coll["model"] += act_f * 2.0 * n_mb * _ring(fwd_psums + ce, tp)
    # rep-segment gathers over model (fwd + remat + bwd scatter)
    rep_bytes = (fs.f_top_r + fs.n_cycles * fs.f_cyc_r) * BF16
    coll["model"] += 3.0 * _gather(rep_bytes, tp)
    if dp_mode == "fsdp":
        sh_bytes = (fs.f_top_s + fs.n_cycles * fs.f_cyc_s) * BF16
        # fwd gather + remat re-gather (per microbatch) + bwd psum_scatter
        passes = ov.get("gather_passes", 2.0 * n_mb + 1.0)
        coll["data"] += passes * _gather(sh_bytes, ma.data)
        notes.append(f"fsdp: {passes:.0f} gather/scatter passes of "
                     f"{sh_bytes / 2**30:.1f} GiB sharded weights; in-pod "
                     "grads fused into backward psum_scatter")
    # gradient exchange (the paper's axis): gs-sgd sketch or dense baseline
    compressor = ov.get("compressor", "gs-sgd")
    sketch_kw = ov.get("sketch",
                       ov.get("compressor_kw",
                              dict(k=65536, rows=5, width=2 ** 17)))
    comp_n = {"dp": dp, "fsdp": ma.pod}[dp_mode]
    if compressor in (None, "none"):
        pass
    elif compressor == "dense":
        if dp_mode == "dp":
            if ma.pod_axis:
                coll["pod"] += _ring(d_local * F32, ma.pod)
                coll["data"] += _ring(d_local * F32, ma.data)
            else:
                coll["data"] += _ring(d_local * F32, dp)
        elif ma.pod_axis:
            coll["pod"] += _ring(d_local * F32, ma.pod)
        notes.append(f"dense gradient exchange: {d_local * F32 / 2**30:.2f} "
                     "GiB payload")
    else:
        wire_b = sketch_kw.get("wire", F32)
        wire = sketch_kw["rows"] * sketch_kw["width"] * wire_b
        k = sketch_kw["k"]
        payload = wire + k * F32
        n_buckets = int(ov.get("buckets") or 1)
        # bucketed modeling is gs-sgd-only: comm_stats / sketch-geometry
        # scaling are properties of the sketch exchange, and the other
        # compressor names keep their monolithic payload model
        if n_buckets > 1 and compressor == "gs-sgd":
            import torch

            from repro_torch.bench.time_breakdown import (ALPHA_1GBE,
                                                          BETA_1GBE,
                                                          hbm_encode_time)
            from repro_torch.core import compression as _comp
            from repro_torch.models.flatten import bucket_sizes
            wire_dt = {2: torch.bfloat16}.get(wire_b, torch.float32)
            base = _comp.make(compressor, k=k, rows=sketch_kw["rows"],
                              width=sketch_kw["width"], wire_dtype=wire_dt)
            bc = _comp.bucketize(base, bucket_sizes(shapes, n_buckets))
            payload = sum(c.sketch.size * wire_b + c.k * F32
                          for c in bc.parts)
            # 2-stage pipeline: bucket i's exchange hides behind bucket
            # i+1's HBM-streaming encode — Eq. 1 at 1 GbE for the comm
            # stage.
            t_enc = [hbm_encode_time(db, c.sketch.rows)
                     for c, db in zip(bc.parts, bc.spec.sizes)]
            t_comm = [c.comm_stats(db, comp_n).time(ALPHA_1GBE, BETA_1GBE)
                      for c, db in zip(bc.parts, bc.spec.sizes)]
            serial, pipelined = _comp.overlap_schedule_time(t_enc, t_comm)
            notes.append(
                f"bucketed x{bc.spec.n}: per-bucket sketch payloads "
                f"{[c.sketch.size * wire_b for c in bc.parts]} B, modeled "
                f"overlap hides {(serial - pipelined) * 1e3:.3f} ms/step "
                f"(serial {serial * 1e3:.2f} -> pipelined "
                f"{pipelined * 1e3:.2f} ms at 1 GbE)")
        if dp_mode == "dp":
            if ma.pod_axis:
                coll["pod"] += _ring(payload, ma.pod)
                coll["data"] += _ring(payload, ma.data)
            else:
                coll["data"] += _ring(payload, dp)
            notes.append(f"gs-sgd exchange over dp axes: sketch "
                         f"{wire / 2**20:.1f} MiB + k={k} second round")
        elif ma.pod_axis:
            coll["pod"] += _ring(payload, ma.pod)
            notes.append("gs-sgd exchange over pod axis only (fsdp)")

    model_flops = 6.0 * cfg.active_params_count(tp) / tp * tokens
    return CellModel(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                     model_flops=model_flops, params_local=params_local,
                     notes=notes)


def serve_cell(cfg: ArchConfig, ma: MeshAxes, dp_mode: str,
               case: ShapeCase, opts: dict | None = None) -> CellModel:
    opts = opts or {}
    notes = []
    tp, dp = ma.tp, ma.dp_size
    shard_batch = case.global_batch % dp == 0
    b_loc = case.global_batch // dp if shard_batch else case.global_batch
    if not shard_batch:
        notes.append("global_batch < dp: batch replicated across dp axes")
    n_layers = cfg.n_layers + (cfg.n_cycles if "shared_attn" in cfg.cycle
                               else 0)
    fs = make_flat_spec(cfg, tp)
    shapes = local_seg_shapes(fs, ma, dp_mode)
    d_local = sum(math.prod(s) for s in shapes.values())
    g = head_geometry(cfg, tp)

    if case.kind == "prefill":
        tokens = b_loc * case.seq_len
        fwd = tokens * _proj_flops_per_layer(cfg, tp) * n_layers
        fwd += sum(_mixer_flops(cfg, tokens, case.seq_len, tp)
                   for _ in range(n_layers))
        vp = padded_vocab(cfg, tp)
        fwd += 2.0 * tokens * cfg.d_model * (vp // tp)
        hbm = d_local * BF16 + tokens * cfg.d_model * BF16 * n_layers * 4
        kv_write = (2 * n_layers * tokens * (1 if g.kv_replicated
                                             else g.nkv_loc) * cfg.hd * BF16)
        hbm += kv_write
        psums = {"attn": 2, "moe": 2, "rwkv": 2, "mamba": 1}.get(cfg.block, 2)
        if opts.get("parallel_block") and cfg.block == "attn":
            psums = 1
        act_f = opts.get("act_comm_factor", 1.0)
        coll = {"model": act_f * _ring((1 + psums * n_layers) * tokens
                                       * cfg.d_model * BF16, tp),
                "data": 0.0, "pod": 0.0}
        mf = 2.0 * cfg.active_params_count(tp) / tp * tokens
        return CellModel(fwd, hbm, coll, mf, d_local, notes)

    # decode: one token per sequence against a case.seq_len cache
    tokens = b_loc
    fwd = tokens * _proj_flops_per_layer(cfg, tp) * n_layers
    fwd += sum(_mixer_flops(cfg, tokens, case.seq_len, tp)
               for _ in range(n_layers))
    vp = padded_vocab(cfg, tp)
    fwd += 2.0 * tokens * cfg.d_model * (vp // tp)
    # HBM: stream all weights once + read the KV cache / states
    hbm = d_local * BF16 * 1.0
    if cfg.block in ("attn", "moe") or cfg.family in ("vlm", "audio"):
        kv = 2 * n_layers * case.seq_len * (1 if g.kv_replicated
                                            else g.nkv_loc) * cfg.hd * BF16
        hbm += kv * b_loc
    if cfg.block == "rwkv":
        nh, hd = rk.rwkv_geometry(cfg, tp)
        hbm += b_loc * (nh // tp) * hd * hd * F32 * n_layers
    if cfg.block == "mamba":
        nh, hd, ns = mb.mamba_geometry(cfg, tp)
        hbm += b_loc * (nh // tp) * ns * hd * F32 * cfg.n_layers
        if "shared_attn" in cfg.cycle:
            hbm += (2 * cfg.n_cycles * case.seq_len
                    * (1 if g.kv_replicated else g.nkv_loc)
                    * cfg.hd * BF16 * b_loc)
    psums = {"attn": 2, "moe": 2, "rwkv": 2, "mamba": 1}.get(cfg.block, 2)
    if opts.get("parallel_block") and cfg.block == "attn":
        psums = 1
    act_f = opts.get("act_comm_factor", 1.0)
    coll = {"model": act_f * _ring((1 + psums * n_layers) * tokens
                                   * cfg.d_model * BF16, tp),
            "data": 0.0, "pod": 0.0}
    mf = 2.0 * cfg.active_params_count(tp) / tp * tokens
    return CellModel(fwd, hbm, coll, mf, d_local, notes)


def cell_model(cfg: ArchConfig, shape: str, ma: MeshAxes, dp_mode: str,
               opts: dict | None = None) -> CellModel:
    case = SHAPES[shape]
    if case.kind == "train":
        return train_cell(cfg, ma, dp_mode, case, opts)
    return serve_cell(cfg, ma, dp_mode, case, opts)
