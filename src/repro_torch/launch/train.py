"""Training driver — spec-first (``repro_torch.api.RunSpec``).

Port of ``repro/launch/train.py``: the flags are generated from the spec
fields, ``--spec SPEC.json`` loads a full spec as the base, and
explicitly-passed flags override it. ``--auto-tune PLAN.json`` merges a
``repro_torch.launch.tune`` plan's exchange config into the base spec
through the same path the manual flags take (bit-exact against passing
``plan.train_argv()`` by hand). P data-parallel workers are simulated on
the leading axis of the state (see ``core/gs_sgd.py``). The run goes on
the CUDA card unless ``--device cpu`` is given; with no card and no
``--device`` it stops with an error.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \
      --workers 2 --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --buckets 4 --bwd-chunks 2 --fuse-encode --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --steps 3 --trace trace.json --json steps.json --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --steps 4 --watch --drift-warmup 1 --drift-delta -1 \
      --drift-threshold 0 --replan-budget 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --auto-tune plan.json --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --steps 4 --ckpt-dir /tmp/ck --ckpt-every 1 --kill-at 2 --device cpu

Checkpoints (``--ckpt-dir``, ``--ckpt-every``) hold the whole train state
(params, optimizer moments, error feedback, step) and the data cursor; the
stream is counter-based (a step's batch depends on the step alone), so a
run resumed with ``--resume`` from the latest checkpoint continues
bit-exactly. ``--kill-at N`` stops after step N as a crash would (tests).

Observability (``repro_torch.obs``): ``--trace PATH`` writes a
Chrome/Perfetto span trace. Every step runs under a driver-level
``step{n}`` span (step 0, and the step after a re-plan, tagged warmup),
and ONE probe step — the second step's inputs, on a copy of the whole
state, its output discarded, so the run's numerics are untouched — runs
with the tracer active, so the step's per-phase spans (each ending in a
device sync) time its phases. ``--json PATH`` writes the
``repro.tune/trace@2`` calibration record: per-step ``t_step``, loss,
bytes and rounds, the static wire stats, the simulator's ``predicted``
step for this spec, the recovery-error probe (an encode and HEAVYMIX
recovery on the run's device) and the provenance stamp; a ``.jsonl`` path
streams one record per line. ``--watch`` streams the step records through
the drift watchdog (``tune/watch.py``): on a sustained drift it refits,
re-plans with the tuner and, where the plan clears the 1% gain bar,
rebuilds the step at the next step boundary, keeping the error-feedback
residual when its layout is unchanged and resetting it otherwise.

The loop is ``drive``: ``main`` and ``chip_smoke.py`` (which drives the
full-width step) both run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch

from repro_torch import api, obs
from repro_torch import ckpt as ckpt_lib
from repro_torch.api import RunSpec
from repro_torch.ckpt.checkpoint import flatten, unflatten
from repro_torch.core import compression as comp
from repro_torch.data import LMStream


def build(spec: RunSpec, device=None):
    """cfg/opt/ma/TrainStep from the spec — the one construction path."""
    cfg = spec.arch_config()
    opt = spec.make_optimizer()
    ma = spec.mesh_axes()
    ts = spec.make_train_step(opt=opt, dtype=torch.float32, device=device)
    if ts.n_buckets > 1:
        sizes = ts.compressor.spec.sizes
        print(f"bucketed exchange: {ts.n_buckets} buckets "
              f"(sizes {list(sizes)}), "
              f"overlap={'on' if spec.exchange.overlap else 'off'}")
    if ts.bwd_chunks and ts.interleave:
        print(f"backward-interleaved readiness: {ts.bwd_chunks} chunk(s), "
              f"bucket readiness {list(ts.plan.readiness)}, "
              f"fuse_encode={'on' if ts.fuse_encode else 'off'}")
    elif ts.bwd_chunks:
        print(f"chunked backward: {ts.bwd_chunks} chunk(s), the exchange "
              "after it (post-accumulation)")
    return cfg, opt, ma, ts


def resolve_spec(args) -> RunSpec:
    """base (--spec file or defaults) <- --auto-tune exchange <- CLI flags."""
    base = RunSpec.load(args.spec) if args.spec else RunSpec()
    if args.auto_tune:
        from repro_torch.tune import TunePlan
        plan = TunePlan.load(args.auto_tune)
        base = dataclasses.replace(
            base, exchange=plan.train_exchange(base.exchange))
        print(f"auto-tune {args.auto_tune}: " + " ".join(plan.train_argv()))
    spec = api.apply_args(base, args, "train")
    if args.auto_tune:
        # only the fields train_exchange() merges are "tuned": flags like
        # --microbatch never shadow the plan
        shadowed = [f for f in ("compressor", "buckets", "bwd_chunks",
                                "sketch")
                    if getattr(spec.exchange, f)
                    != getattr(base.exchange, f)]
        if shadowed:
            print("note: explicit flags override the plan's exchange "
                  "config: " + ", ".join(shadowed))
    spec.validate()
    return spec


def shard_batch(gb: dict, nworkers: int) -> dict:
    """(B, S) global batch -> (P, B/P, S) per-worker rows."""
    out = {}
    for k, v in gb.items():
        if v.shape[0] % nworkers:
            raise ValueError(f"global batch {v.shape[0]} is not divisible "
                             f"by {nworkers} workers")
        out[k] = v.reshape((nworkers, v.shape[0] // nworkers) + v.shape[1:])
    return out


def train_loop(ts, state: dict, batch_at, steps, *, log_every: int = 10,
               last: int | None = None, after_step=None):
    """Run ``ts.fn`` over ``steps`` with nothing attached; ``batch_at(step)``
    gives the global batch. Returns (state, losses, per-step seconds)
    (``drive`` without a tracer, recorder or watchdog)."""
    out = drive(None, ts, state, batch_at, steps, log_every=log_every,
                last=last, after_step=after_step)
    return out["state"], out["history"], out["times"]


# ---------------------------------------------------------------------------
# The probe's state copy, the EF layout rule, the trace@2 record
# ---------------------------------------------------------------------------


def _tensors(tree) -> list:
    return [x for x in flatten(tree)[0] if isinstance(x, torch.Tensor)]


def clone_state(state: dict) -> dict:
    """A copy of every tensor of the state (params, optimizer moments, error
    feedback): the probe step runs on it, since the step updates the
    optimizer moments in place. The step draws from no generator the run
    keeps (the faithful fill seeds its own), so nothing else is copied."""
    return unflatten(state, [x.clone() if isinstance(x, torch.Tensor)
                             else x for x in flatten(state)[0]])


def state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(state))


def _layout(tree) -> tuple:
    """Structure, shapes and dtypes of an EF state (the keep/reset rule)."""
    leaves, paths = flatten(tree)
    return tuple(paths), tuple((tuple(x.shape), x.dtype) for x in leaves)


def fresh_ef(ts, device):
    return (ts.compressor.init(ts.d_local, ts.nworkers, device)
            if ts.compressor is not None
            else torch.zeros((ts.nworkers, 0), device=device))


def rebase_ef(state: dict, ts) -> tuple[dict, bool]:
    """The state for a rebuilt step: error feedback carries over only when
    the new exchange keeps its layout (the reference's rule); a geometry
    change (bucket count, sketch size) resets it to zeros. Returns (state,
    kept)."""
    if _layout(state["ef"]) == _layout(fresh_ef(ts, "meta")):
        return state, True
    return {**state, "ef": fresh_ef(ts, ts.device)}, False


def ef_norm(state: dict) -> float:
    """l2 norm of worker 0's error-feedback residual."""
    tot = 0.0
    for leaf in _tensors(state["ef"]):
        if leaf.numel() == 0:
            continue
        tot += float(torch.linalg.vector_norm(
            leaf[0].reshape(-1), dtype=torch.float64)) ** 2
    return math.sqrt(tot)


def predicted(spec: RunSpec) -> dict:
    """Sim-priced step for the trace@2 ``predicted`` block: the jitter-free
    ``replay.predict_step`` on this spec's cluster. A spec the simulator
    cannot price (a compressor it does not replay) gives ``{"error": ...}``,
    as in the reference."""
    from repro_torch.sim import replay
    try:
        cfg = spec.sim_config()
    except ValueError as e:
        return {"error": str(e)}
    r = replay.predict_step(
        cfg.method, cfg.d, cfg.p, buckets=cfg.buckets,
        bwd_chunks=cfg.bwd_chunks, k=cfg.k, rows=cfg.rows,
        width=cfg.width, shape=cfg.shape, topology=cfg.topology,
        link=cfg.link, intra_link=cfg.intra_link,
        group_size=cfg.group_size, overlap=cfg.overlap,
        fuse_encode=cfg.fuse_encode, t_compute=cfg.compute.mean,
        bwd_frac=cfg.bwd_frac, wire_dtype_bytes=cfg.wire_dtype_bytes,
        net=spec.cluster.network())
    return {"step_time": r["step_time"], "exposed_comm": r["comm"],
            "hidden_comm": max(0.0, r["comm_serial"] - r["comm"]),
            "encode": r["encode"], "comm": r["comm"],
            "recover": r["recover"]}


def recovery_probe(ts, seed: int) -> float | None:
    """HEAVYMIX recovery-error probe on the run's RESOLVED per-bucket
    sketch geometry: 1 - captured l2 mass on a seeded heavy-tailed probe
    (the ``tune/cost.py`` error proxy, measuring the run as built), encoded
    and recovered on the run's device (the kernels, on the card). None for
    non-sketch compressors."""
    import numpy as np

    from repro_torch.core import count_sketch as cs
    from repro_torch.tune.cost import probe_gradient, recovery_error
    if isinstance(ts.compressor, comp.BucketedCompressor):
        parts = list(zip(ts.compressor.parts, ts.compressor.spec.sizes))
    else:
        parts = [(ts.compressor, ts.d_local)]
    if not all(hasattr(c, "sketch") for c, _ in parts):
        return None
    scale = min(1.0, (1 << 14) / max(1, ts.d_local))
    missed = total = 0.0
    for i, (c, d_b) in enumerate(parts):
        d_p = max(64, int(round(d_b * scale)))
        k_p = max(1, min(d_p, int(round(c.k * scale))))
        w_p = min(int(c.sketch.width), max(64, 1 << int(math.floor(
            math.log2(max(c.sketch.width * scale, 64))))))
        u = np.asarray(probe_gradient(d_p, seed=seed + i))
        cfg = cs.SketchConfig(rows=c.sketch.rows, width=w_p,
                              seed=c.sketch.seed)
        m, t = recovery_error(u, cfg, k_p, ts.device)
        missed += m
        total += t
    return missed / total if total > 0 else 0.0


class Trace2Recorder:
    """The ``repro.tune/trace@2`` record of a run: per-step rows (the
    trace@1 keys step/t_step/rounds/bytes/loss, warmup tags, quality
    metrics), the static comm stats, metrics, ``predicted`` and the
    recovery-error probe at the end."""

    def __init__(self, spec: RunSpec, ts, provenance: dict | None = None):
        self.provenance = provenance
        self.metrics = obs.Metrics()
        self.records: list[dict] = []
        self.rebuild(spec, ts)

    def rebuild(self, spec: RunSpec, ts) -> None:
        """The step was (re)built from ``spec``: new static stats."""
        self.spec, self.ts = spec, ts
        self.stats = comp.static_comm_stats(ts.compressor, ts.d_local,
                                            ts.nworkers)

    def record(self, step: int, t_step: float, loss: float, warm: bool,
               m: dict, state: dict) -> dict:
        st, p = self.stats, self.ts.nworkers
        bw = st.bytes_out * p
        rec = {"step": step, "t_step": t_step, "loss": loss,
               "rounds": st.rounds, "bytes": st.bytes_out, "warmup": warm,
               "grad_norm": float(m["grad_norm"][0]),
               "ef_residual_norm": ef_norm(state),
               "bytes_wire": bw,
               "compression_ratio": (self.ts.d_local * 4.0 / st.bytes_out
                                     if st.bytes_out else None)}
        self.records.append(rec)
        self.metrics.counter("bytes_wire").inc(bw)
        self.metrics.counter("rounds").inc(st.rounds)
        if not warm:
            self.metrics.histogram("t_step").observe(t_step)
        return rec

    def document(self, arch: str) -> dict:
        spec, ts, p, met = self.spec, self.ts, self.ts.nworkers, self.metrics
        ex = spec.exchange
        sk = ex.sketch.resolve(ts.d_local)
        model = {"arch": arch, "p": p, "d": ts.d_local,
                 "compressor": ex.compressor, "buckets": ex.buckets,
                 "bwd_chunks": ex.bwd_chunks, "overlap": ex.overlap,
                 "k": sk.k, "rows": sk.rows, "width": sk.width,
                 "seed": spec.seed, "bytes_per_step": self.stats.bytes_out,
                 "rounds_per_step": self.stats.rounds}
        pred = predicted(spec)
        if "step_time" in pred:
            met.gauge("exposed_comm").set(pred["exposed_comm"])
            met.gauge("hidden_comm").set(pred["hidden_comm"])
        per = getattr(self.stats, "per_bucket", None)
        if per:   # wire bytes per bucket over the whole capture
            for i, s in enumerate(per):
                met.counter(f"bytes_wire/b{i}").inc(
                    s.bytes_out * p * len(self.records))
        err = recovery_probe(ts, spec.seed)
        if err is not None:
            met.gauge("recovery_error_probe").set(err)
        return obs.trace2_doc(model=model, records=self.records,
                              metrics=met, provenance=self.provenance,
                              predicted=pred)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def _sync(ts) -> None:
    if ts.device.type == "cuda":
        torch.cuda.synchronize(ts.device)


def probe_step(tracer, ts, state: dict, batch: dict, step: int) -> dict:
    """Run the step once with ``tracer`` active, on a copy of ``state``,
    and discard the result: its per-phase spans land in the tracer under
    one ``probe`` span. Returns the copy's bytes and the probe's seconds."""
    _sync(ts)
    copy = clone_state(state)
    nbytes = state_bytes(copy)
    _sync(ts)
    t0 = time.perf_counter()
    with tracer.activate():
        with tracer.span("probe", cat="probe", args={"step": step}) as sp:
            out = sp.sync(ts.fn(copy, batch))
    seconds = time.perf_counter() - t0
    del out, copy
    return {"step": step, "copy_bytes": nbytes, "seconds": seconds}


def drive(spec: RunSpec | None, ts, state: dict, batch_at, steps, *,
          rebuild=None, tracer=None, recorder: Trace2Recorder | None = None,
          watchdog=None, log_every: int = 10, last: int | None = None,
          after_step=None) -> dict:
    """Run the train step over ``steps`` (``batch_at(step)`` gives the
    global batch), each step timed on the host clock up to a device sync.

    tracer: an ``obs.Tracer``: every step under a ``step{n}`` span (its
    batch made and sharded before it, under ``step/input``), and one
    probe step (``probe_step``) before the second step (the first, for a
    one-step run). recorder: a ``Trace2Recorder`` fed every step.
    watchdog: a ``tune.Watchdog`` fed every step's record; when it returns
    a new spec the step is rebuilt by ``rebuild(spec) -> TrainStep`` and
    the state rebased (``rebase_ef``). ``after_step(step, state, loss)``
    runs after each step (the checkpoint hook); the loop stops when it
    returns True.

    Returns {"state", "spec", "ts", "history", "times", "probe",
    "replans"}."""
    steps = list(steps)
    history, times, replans = [], [], []
    probe = None
    probe_at = None
    if tracer is not None and steps:
        probe_at = steps[1] if len(steps) > 1 else steps[0]
    tnull = tracer if tracer is not None else obs.NULL
    start = steps[0] if steps else 0
    replanned_at = None   # the step after a re-plan is tagged warmup
    t0 = time.time()
    for step in steps:
        with tnull.span("step/input", cat="detail"):
            batch = ts.shard(batch_at(step))
        if step == probe_at:
            probe = probe_step(tracer, ts, state, batch, step)
        warm = step == start or replanned_at == step - 1
        t_step0 = time.perf_counter()
        with tnull.span(f"step{step}", cat="step",
                        args={"step": step, "warmup": warm}):
            state, m = ts.fn(state, batch)
            _sync(ts)
            loss = float(m["loss"])
        t_step = time.perf_counter() - t_step0
        history.append(loss)
        times.append(t_step)
        if recorder is not None:
            recorder.record(step, t_step, loss, warm, m, state)
        del m
        if watchdog is not None:
            new = watchdog.on_step(
                {"step": step, "t_step": t_step, "warmup": warm,
                 "p": ts.nworkers}, now=time.time() - t0)
            if new is not None:
                ev = watchdog.log[-1]
                print(f"watchdog: re-planned at step {step} -> "
                      f"{ev['choice']} (predicted step "
                      f"{ev['predicted'] * 1e3:.2f}ms vs current "
                      f"{ev['current'] * 1e3:.2f}ms, gain {ev['gain']:.1%})")
                spec = new
                ts = rebuild(spec)
                state, kept = rebase_ef(state, ts)
                if not kept:
                    print("watchdog: error-feedback reset "
                          "(exchange geometry changed)")
                if recorder is not None:
                    recorder.rebuild(spec, ts)
                replans.append({"step": step, "ef_kept": kept,
                                **{k: ev[k] for k in ("choice", "predicted",
                                                      "current", "gain")}})
                replanned_at = step
        if step % log_every == 0 or step == last:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if after_step is not None and after_step(step, state, loss):
            break
    return {"state": state, "spec": spec, "ts": ts, "history": history,
            "times": times, "probe": probe, "replans": replans}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="gs-SGD training driver "
                                             "(PyTorch port)")
    api.add_spec_args(ap, "train")
    ap.add_argument("--spec", default=None, metavar="SPEC.json",
                    help="load a RunSpec as the base config (explicit "
                         "flags still override)")
    ap.add_argument("--dump-spec", default=None, metavar="PATH",
                    help="write the fully-resolved RunSpec JSON and continue")
    ap.add_argument("--auto-tune", default=None, metavar="PLAN.json",
                    help="merge a repro_torch.launch.tune plan's exchange "
                         "config into the base spec (bit-exact vs passing "
                         "the same flags manually)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write a repro.tune/trace@2 calibration trace, "
                         "consumable by repro_torch.launch.tune "
                         "--calibrate; a .jsonl path streams one record "
                         "per line")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="simulate a crash after this step (tests)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    spec = resolve_spec(args)
    if args.dump_spec:
        spec.save(args.dump_spec)
        print(f"wrote resolved spec to {args.dump_spec}")
    cfg, opt, ma, ts = build(spec, args.device)
    watchdog = None
    if spec.watch.enabled:
        from repro_torch.tune.watch import Watchdog
        watchdog = Watchdog(spec)   # raises now if the compressor cannot
        w = spec.watch              # be re-planned (sim-replayable only)
        print(f"watchdog armed: warmup={w.warmup} delta={w.delta} "
              f"threshold={w.threshold} window={w.window} "
              f"budget={w.replan_budget}")
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                      global_batch=spec.batch, seed=spec.seed)
    gen = torch.Generator(device=ts.device).manual_seed(spec.seed)
    state = ts.init_state(opt, gen)
    start, saver = 0, None
    if spec.ckpt_dir:
        saver = ckpt_lib.AsyncCheckpointer(spec.ckpt_dir, keep=3)
        if args.resume and ckpt_lib.latest_step(spec.ckpt_dir) is not None:
            state, meta = ckpt_lib.restore(spec.ckpt_dir, state,
                                           device=ts.device)
            start = meta["step"]
            gen.set_state(torch.tensor(meta["generator_state"],
                                       dtype=torch.uint8))
            print(f"resumed from step {start}")

    tracer = obs.Tracer() if spec.trace else None
    prov = (obs.provenance(spec, ts.device) if (spec.trace or args.json)
            else None)
    recorder = Trace2Recorder(spec, ts, prov) if args.json else None

    def meta_at(step: int, loss: float) -> dict:
        return {"loss": loss, "data_cursor": step, "seed": spec.seed,
                "generator_state": gen.get_state().tolist(),
                "device": str(ts.device)}

    def after_step(step: int, state: dict, loss: float) -> bool:
        if saver and (step + 1) % spec.ckpt_every == 0:
            saver.save(step + 1, state, meta_at(step + 1, loss))
        if args.kill_at is not None and step + 1 >= args.kill_at:
            print(f"simulated crash at step {step + 1}")
            return True
        return False

    def rebuild(new_spec: RunSpec):
        return build(new_spec, args.device)[3]

    out = drive(spec, ts, state, lambda s: stream.global_batch_at(
        s, ts.device), range(start, spec.steps), rebuild=rebuild,
        tracer=tracer, recorder=recorder, watchdog=watchdog,
        log_every=args.log_every, last=spec.steps - 1,
        after_step=after_step)
    state, history = out["state"], out["history"]

    def finish() -> None:
        if recorder is not None:
            obs.dump(recorder.document(cfg.name), args.json)
            print(f"wrote {args.json} ({len(recorder.records)} records)")
        if tracer is not None:
            doc = tracer.save(spec.trace, spec=spec, provenance=prov,
                              source="train")
            print(f"wrote {spec.trace} ({len(doc['traceEvents'])} events)")

    if args.kill_at is not None and start + len(history) >= args.kill_at:
        if saver:
            saver.wait()
        finish()
        return {"history": history, "crashed_at": start + len(history)}
    if saver:
        saver.save(spec.steps, state, meta_at(spec.steps, history[-1]))
        saver.wait()
    finish()
    result = {"history": history, "final_loss": history[-1], "state": state}
    if watchdog is not None:
        result["watch"] = list(watchdog.log)
    print(json.dumps({"final_loss": history[-1], "steps": len(history)}))
    return result


if __name__ == "__main__":
    main()
