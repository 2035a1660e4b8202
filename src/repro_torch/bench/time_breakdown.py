"""Paper Figs. 4-5: per-iteration time breakdown t_compu / t_compr / t_commu.

Port of ``benchmarks/time_breakdown.py``. Two columns a method:

* measured — on the run's device (the card unless ``--device cpu``): one
  worker's forward + backward (``t_compu``) and its compression
  (``t_compr``), host clock around calls that end in
  ``torch.cuda.synchronize()``. For gs-SGD and Sketched-SGD ``t_compr``
  is the encode (``kernels.ops.encode``: the encode kernel and its
  finish); for gTop-k it is (1 + rounds) x the local top-k the port's
  ``GTopK`` runs a hop (``core.heavymix.topk_lower_index`` of |v|).
* modelled — the reference's accelerator model, kept so the port prices
  what the reference prices: compute at ``sim.replay.ACCEL_FLOPS`` (50
  TFLOP/s, an assumed rate, not the card's) over the gradient's flops
  (counted with ``torch.utils.flop_counter.FlopCounterMode``, where the
  reference reads XLA's ``cost_analysis``), compression at
  ``sim.replay.ENCODE_BW`` (819 GB/s, a TPU v5e's HBM rate, not the
  card's).

Communication in both columns is the paper's Eq. 1 at 1 GbE
(``sim.network.LINK_1GBE``: alpha 0.5 ms, beta 8 ns/B) on each method's
CommStats; no network is measured.

    python -m repro_torch.bench.time_breakdown [--device cpu] [--out DIR]

writes ``time_breakdown.json`` under ``experiments/bench_torch/`` (or
``--out``).
"""

from __future__ import annotations

import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.bench import cnn_dist
from repro_torch.core import allreduce as ar
from repro_torch.core import compression as comp
from repro_torch.core import count_sketch as cs
from repro_torch.core.heavymix import topk_lower_index
from repro_torch.data import ImageStream
from repro_torch.kernels import ops
from repro_torch.models import cnn
from repro_torch.sim.network import LINK_1GBE
from repro_torch.sim.replay import (ACCEL_FLOPS, ENCODE_BW, TOPK_PASSES,
                                    bucket_readiness, event_times)

ALPHA_1GBE = LINK_1GBE.alpha  # per-round startup, seconds (the model's)
BETA_1GBE = LINK_1GBE.beta    # seconds per byte at 1 Gbit/s (the model's)
HBM_BW = ENCODE_BW            # the model's memory rate (bytes/s)

METHODS = ["gs-sgd", "sketched-sgd", "gtopk"]
# The reference's reduced widths for this driver (full size: throughput).
REDUCED = {"resnet20": {"width": 8}, "vgg16": {"width_mult": 0.25}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(f, device, n=5) -> float:
    """Mean host seconds of ``f()`` over ``n`` calls, each ended by a
    device sync, after one warm-up call."""
    f()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        f()
        _sync(device)
    return (time.perf_counter() - t0) / n


def hbm_encode_time(d: int, rows: int, hbm: float = HBM_BW) -> float:
    """Sketch-encode compute stage priced at the model's memory rate:
    read+write (8 B) per coordinate per row."""
    return d * rows * 8 / hbm


def paper_geometry(d: int) -> tuple[int, int]:
    """Paper-regime sparsity: k = 0.4% of d (Sec. IV-A final density);
    sketch width ~ k/2 so the sketch payload undercuts gTop-k's per-round
    2k (value, index) payload."""
    k = max(64, int(0.004 * d))
    width = 1 << max(8, (k // 2 - 1).bit_length())
    return k, width


def grad_fn(model: str, params: dict, images, labels):
    """A closure computing one worker's gradient (the leaves' gradients)
    of the CE loss at ``params`` on ``images``."""
    _, apply = cnn.MODELS[model]
    tree, leaves = cnn_dist.grad_leaves(*cs.ravel_tree(params))

    def f():
        with torch.enable_grad():
            loss = cnn.ce_loss(apply(tree, images), labels)
            return torch.autograd.grad(loss, leaves)

    return f


def count_flops(f) -> int:
    """Flops of one call of ``f`` (matmuls and convolutions, forward and
    backward; ``FlopCounterMode``)."""
    with FlopCounterMode(display=False) as counter:
        f()
    return int(counter.get_total_flops())


def breakdown(model: str, method: str, *, P=4, k=None, width=None,
              width_kw=None, device=None) -> dict:
    """One worker's t_compu, t_compr and t_commu for ``method`` at
    ``model``'s d (k and W from ``paper_geometry`` unless given), measured
    and modelled, with the CommStats behind t_commu."""
    device = cnn_dist.prepare_device(device)
    p0 = cnn_dist.init_params(model, device, width_kw)
    d = sum(x.numel() for x in cs.tree_leaves(p0))
    if k is None or width is None:
        k, width = paper_geometry(d)
    b = ImageStream(global_batch=32).global_batch_at(0, device)
    imgs, labs = b["images"][:8], b["labels"][:8]

    # ---- t_compu: forward+backward (measured; modelled via flop count) ---
    f = grad_fn(model, p0, imgs, labs)
    t_compu = _time(f, device, n=5 if device.type == "cpu" else 20)
    flops = count_flops(f)
    t_compu_model = max(flops / ACCEL_FLOPS, 1e-5)

    # ---- t_compr -----------------------------------------------------------
    kw: dict = dict(k=k)
    if method in ("gs-sgd", "sketched-sgd"):
        kw.update(rows=5, width=width)
    c = comp.make(method, **kw)
    g = torch.randn((d,), generator=torch.Generator(device=device)
                    .manual_seed(1), device=device)
    rounds_tree = ar.tree_allreduce_rounds(P) // 2
    n_rep = 2 if d > 5_000_000 and device.type == "cpu" else 5
    if method in ("gs-sgd", "sketched-sgd"):
        t_compr = _time(lambda: ops.encode(c.sketch, g), device, n=n_rep)
        t_compr_model = hbm_encode_time(d, c.sketch.rows)
    else:
        # gTop-k re-sparsifies the merged vector once per tree round
        # (sequential, on the critical path): (1 + rounds) top-k over d.
        t_local = _time(lambda: topk_lower_index(g.abs(), k), device,
                        n=n_rep)
        t_compr = (1 + rounds_tree) * t_local
        # the model: top-k over d as ~10 passes of a radix select
        t_compr_model = (1 + rounds_tree) * (TOPK_PASSES * d * 4 / HBM_BW)

    # ---- t_commu: paper Eq. 1 on the method's CommStats -------------------
    stats = c.comm_stats(d, P)
    t_commu = stats.time(ALPHA_1GBE, BETA_1GBE)
    return {"t_compu": t_compu, "t_compr": t_compr, "t_commu": t_commu,
            "t_compu_model": t_compu_model, "t_compr_model": t_compr_model,
            "bytes": stats.bytes_out, "rounds": stats.rounds, "d": d,
            "k": k, "width": width if method != "gtopk" else None,
            "flops": flops}


def model_bucket_pipeline(d: int, n_buckets: int, *, P: int = 4,
                          k: int | None = None, width: int | None = None,
                          rows: int = 5, alpha: float = ALPHA_1GBE,
                          beta: float = BETA_1GBE, hbm: float = HBM_BW,
                          t_backward: float = 0.0,
                          bwd_chunks: int | None = None) -> dict:
    """Per-bucket CommStats + modelled comm/compute-overlap saving of the
    bucketed gs-SGD exchange on Eq. 1, with the readiness schedule of the
    backward interleave (``sim.replay.bucket_readiness``) and the 3-stage
    ``compression.interleaved_schedule_time`` recurrence; the reference's
    function, priced the same way (a model, not a measurement)."""
    if k is None or width is None:
        k, width = paper_geometry(d)
    base = comp.make("gs-sgd", k=k, rows=rows, width=width)
    bc = comp.bucketize(base, comp.even_bucket_sizes(d, n_buckets))
    n = bc.spec.n
    kc = n if bwd_chunks is None else max(1, int(bwd_chunks))
    per, t_enc, t_comm = [], [], []
    for c, db in zip(bc.parts, bc.spec.sizes):
        stats = c.comm_stats(db, P)
        per.append({"d": db, "k": c.k, "width": c.sketch.width,
                    "bytes": stats.bytes_out, "rounds": stats.rounds,
                    "t_comm": stats.time(alpha, beta)})
        t_enc.append(hbm_encode_time(db, c.sketch.rows, hbm=hbm))
        t_comm.append(stats.time(alpha, beta))
    ev_t = event_times(t_backward, kc)
    ready = [ev_t[e] for e in bucket_readiness(bc.spec.offsets,
                                               bc.spec.sizes, d, kc)]
    serial, pipelined, exposed, _ = comp.interleaved_schedule_time(
        t_enc, t_comm, ready, t_backward=t_backward)
    return {"n_buckets": n, "bwd_chunks": kc, "per_bucket": per,
            "t_serial": serial, "t_pipelined": pipelined,
            "t_exposed": exposed, "overlap_saving": serial - pipelined}


def main(device=None, out: str | None = None,
         models=("resnet20", "vgg16")) -> dict:
    device = cnn_dist.prepare_device(device)
    results: dict = {}
    for model in models:
        per: dict = {}
        for method in METHODS:
            r = breakdown(model, method, width_kw=REDUCED[model],
                          device=device)
            per[method] = r
            tot = r["t_compu"] + r["t_compr"] + r["t_commu"]
            tot_m = r["t_compu_model"] + r["t_compr_model"] + r["t_commu"]
            print(f"{model:9s} {method:12s} measured ({device.type}): "
                  f"compu {r['t_compu'] * 1e3:8.3f} compr "
                  f"{r['t_compr'] * 1e3:8.3f} commu "
                  f"{r['t_commu'] * 1e3:7.3f} tot {tot * 1e3:8.3f} ms | "
                  f"modelled tot {tot_m * 1e3:7.3f} ms", flush=True)
        # bucketed gs-SGD: per-bucket CommStats and the modelled saving,
        # post-accumulation and backward-interleaved (bwd_chunks = n_b)
        d = per["gs-sgd"]["d"]
        tb = per["gs-sgd"]["t_compu_model"]
        per["bucketed"] = {}
        for n_b in (1, 4, 8):
            r = model_bucket_pipeline(d, n_b)
            sched = model_bucket_pipeline(d, n_b, t_backward=tb,
                                          bwd_chunks=n_b)
            r["interleaved"] = {key: sched[key] for key in
                                ("t_serial", "t_pipelined", "t_exposed",
                                 "overlap_saving")}
            per["bucketed"][str(n_b)] = r
            print(f"{model:9s} gs-sgd x{r['n_buckets']:<2d} buckets "
                  f"(modelled): serial {r['t_serial'] * 1e3:6.2f} ms "
                  f"pipelined {r['t_pipelined'] * 1e3:6.2f} ms saving "
                  f"{r['overlap_saving'] * 1e3:6.3f} ms (interleaved "
                  f"{sched['overlap_saving'] * 1e3:6.3f} ms)", flush=True)
        results[model] = per
    results["device"] = cnn_dist.device_record(device)
    cnn_dist.write_json(results, "time_breakdown.json", out)
    return results


if __name__ == "__main__":
    cnn_dist.cli(main, __doc__)
