"""Continuous-batching serving demo on a mixed SSM + KV cache.

Port of ``examples/serve_batched.py``, on the card unless ``--device
cpu``. Uses the zamba2 (Mamba2 + shared-attention hybrid) smoke config
through the ``repro_torch.serve`` engine: the shared-attention KV pages
through the ``PagedKVCache`` block allocator while the Mamba recurrent
states stay dense per-slot. Requests arrive staggered with mixed lengths
(drawn from a ``torch.Generator``), so slots admit and retire
mid-generation.

    python -m repro_torch.examples.serve_batched [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import api
from repro_torch.configs import SMOKES
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.models.flatten import init_flat_params, make_flat_spec
from repro_torch.serve import PagedKVCache, Request, ServeEngine
from repro_torch.serve.scheduler import serve_fns

CFG = SMOKES["zamba2-2.7b"]
B, PROMPT, GEN = 4, 24, 12


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def requests(n: int) -> list[Request]:
    """``n`` staggered requests: prompts of 8..PROMPT tokens, 4..GEN new
    tokens, from a CPU generator seeded 1."""
    gen = torch.Generator().manual_seed(1)

    def draw(lo, hi, size=()):
        return torch.randint(lo, hi, size, generator=gen)

    out = []
    for i in range(n):
        n_prompt = int(draw(8, PROMPT + 1))
        prompt = tuple(int(x) for x in draw(1, CFG.vocab_size, (n_prompt,)))
        out.append(Request(rid=i, prompt=prompt,
                           max_new=int(draw(4, GEN + 1)), arrival=i * 0.002))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fs = make_flat_spec(CFG, 1)
    segs = init_flat_params(CFG, torch.Generator(device).manual_seed(0), 1,
                            fs, device=device)

    base = api.RunSpec(smoke=True)
    spec = dataclasses.replace(base, arch="zamba2-2.7b",
                               serve=dataclasses.replace(
                                   base.serve, batch=B, prompt_len=PROMPT,
                                   gen=GEN, block_size=8))
    spec.validate()
    fns = serve_fns(CFG, fs)
    reqs = requests(2 * B)

    def run():
        eng = ServeEngine(CFG, fs, segs, spec, fns=fns)
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        _sync(device)
        t0 = time.perf_counter()
        while eng.pending():
            eng.step()
        _sync(device)
        return eng, time.perf_counter() - t0

    eng, cold = run()            # first calls (allocator, kernel caches)
    eng, dt = run()              # steady state

    cache = eng.cache
    assert isinstance(cache, PagedKVCache)
    n_leaves = len(tree_leaves(cache.state)) + len(tree_leaves(cache.pool))
    print(f"arch {CFG.name}: cycle={CFG.cycle}, mixed cache has "
          f"{n_leaves} leaves (dense SSM states + paged shared-attn KV, "
          f"{cache.num_blocks} blocks x {cache.block_size} positions)")
    comps = sorted(eng.completions.values(), key=lambda c: c.rid)
    n_tok = sum(len(c.tokens) for c in comps)
    print(f"served {len(comps)} requests / {n_tok} tokens in "
          f"{eng.n_steps} decode steps, steady wall {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s; cold {cold:.2f}s)")
    assert cache.free_blocks == cache.num_blocks - 1, "leaked blocks"
    for c in comps[:B]:
        print(f"  rid {c.rid}: {c.tokens}")
    return {"requests": len(reqs), "completed": len(comps),
            "finish": [c.finish for c in comps], "tokens": n_tok,
            "decode_steps": eng.n_steps, "steady_s": dt, "cold_s": cold,
            "tok_per_s": n_tok / dt, "free_blocks": cache.free_blocks,
            "num_blocks": cache.num_blocks}


if __name__ == "__main__":
    main()
