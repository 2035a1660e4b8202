"""The system under test: ``repro_torch``'s gs-SGD train step, built and
driven through its public API (``make_train_step``, ``TrainStep.fn``,
``launch.train.train_loop``).

Before a run the step's own layout and exchange plan are held to the
configuration file's: the flat segments and every leaf's place, the
bucket sizes, each bucket's k, sketch width, hash seed and rows, the
all-reduce mode. A program that departs from them fails the run instead
of being compared with a reference of another geometry.
"""

from __future__ import annotations

import dataclasses

import torch

from pbench import layout as lay_mod


def arch_config(conf: dict):
    """The port's ``ArchConfig`` for a configuration file: its registry
    entry with every size the file states."""
    from repro_torch import configs
    s = lay_mod.Shape.of(conf)
    return dataclasses.replace(
        configs.get(conf["registry"]), n_layers=s.n_layers,
        d_model=s.d_model, n_heads=s.n_heads, n_kv_heads=s.n_kv_heads,
        head_dim=s.head_dim, d_ff=s.d_ff, vocab_size=s.vocab_size,
        tie_embeddings=s.tie_embeddings, norm_eps=s.norm_eps,
        rope_theta=s.rope_theta)


def optimizer(conf: dict):
    from repro_torch.optim import make
    o = conf["optimizer"]
    if o["name"] != "adamw":
        raise ValueError(f"optimizer {o['name']!r}: the reference has AdamW")
    return make("adamw", lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"])


def build_step(conf: dict, traffic: dict, device):
    """The train step of the cell: gs-SGD, the configuration's buckets and
    sketch rows, k and widths derived from d by the program (the file
    states what they must come to), the traffic's all-reduce mode and
    workers, simulated on one device."""
    from repro_torch.api import ExchangeSpec, SketchSpec
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    ex = conf["exchange"]
    spec = ExchangeSpec(
        compressor="gs-sgd", buckets=len(ex["buckets"]), overlap=True,
        allreduce_mode=traffic["allreduce_mode"],
        sketch=SketchSpec(rows=ex["rows"], width=None, k=None,
                          seed=ex["buckets"][0]["hash_seed"]))
    ma = MeshAxes(tp=1, data=int(traffic["workers"]), tp_axis=None)
    ts = make_train_step(arch_config(conf), ma, optimizer(conf), spec=spec,
                         dtype=torch.float32, device=device,
                         remat=bool(conf["remat"]))
    check_step(ts, conf, traffic)
    return ts


def check_step(ts, conf: dict, traffic: dict) -> None:
    """Raise where the step's layout or exchange plan departs from the
    configuration file's (module docstring)."""
    lay = lay_mod.layout(lay_mod.Shape.of(conf))
    fs = ts.fs
    got = {k: tuple(v) for k, v in fs.seg_shapes().items()}
    want = {k: ((n,) if k.startswith("top") else (rows, n))
            for k, (_, rows, n) in lay.segments.items()}
    if got != want:
        raise RuntimeError(f"flat segments {got} differ from the "
                           f"configuration's {want}")
    port = sorted([(("top_r" if l.rep else "top_s"), l.offset, l.size)
                   for l in fs.top_leaves]
                  + [(("cycles_r" if l.rep else "cycles_s"), l.offset,
                      l.size) for l in fs.cyc_leaves])
    mine = []
    for l in lay.leaves:
        if l.name.startswith("layer") and not l.name.startswith("layer0/"):
            continue
        for name, (off, rows, n) in lay.segments.items():
            if off <= l.offset < off + rows * n:
                mine.append((name, l.offset - off, l.size))
    if port != sorted(mine):
        raise RuntimeError("the step's leaf layout differs from the "
                           "configuration's")
    ex = conf["exchange"]
    comp = ts.compressor
    plan = [{"d": int(d), "k": int(c.k), "width": int(c.sketch.width),
             "hash_seed": int(c.sketch.seed), "rows": int(c.sketch.rows),
             "allreduce_mode": c.allreduce_mode, "encoder": c.encoder,
             "faithful": bool(c.faithful_heavymix)}
            for d, c in zip(comp.spec.sizes, comp.parts)]
    want = [{"d": b["d"], "k": b["k"], "width": b["width"],
             "hash_seed": b["hash_seed"], "rows": ex["rows"],
             "allreduce_mode": traffic["allreduce_mode"],
             "encoder": "exact", "faithful": False} for b in ex["buckets"]]
    if plan != want:
        raise RuntimeError(f"the step's exchange plan {plan} differs from "
                           f"the configuration's {want}")
    if ts.d_local != lay.d:
        raise RuntimeError(f"d {ts.d_local} != the configuration's {lay.d}")

