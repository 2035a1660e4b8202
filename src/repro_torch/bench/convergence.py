"""Paper Figs. 2-3: convergence of gs-SGD against gTop-k, Sketched-SGD and
the other compressors.

Port of ``benchmarks/convergence.py``: ResNet-20 (``width=8``) and VGG-16
(``width_mult=0.25``), CIFAR geometry with synthetic learnable classes,
P = 4 workers, k = 2,048, R = 5, W = 8,192, lr 0.02 (``cnn_dist.run``).
The claim under test: gs-SGD's convergence matches Sketched-SGD's (the
same math, another aggregation) and is no worse than gTop-k's at equal k.

    python -m repro_torch.bench.convergence [--device cpu] [--steps N]
        [--out DIR]

writes ``convergence.json`` under ``experiments/bench_torch/``.
"""

from __future__ import annotations

from repro_torch.bench import cnn_dist

METHODS = ["gs-sgd", "sketched-sgd", "gtopk", "fetchsgd", "signsgd",
           "dense"]
WIDTHS = {"resnet20": {"width": 8}, "vgg16": {"width_mult": 0.25}}


def main(steps: int = 40, models=("resnet20", "vgg16"), device=None,
         out: str | None = None) -> dict:
    device = cnn_dist.prepare_device(device)
    results: dict = {}
    for model in models:
        per = {}
        for method in METHODS:
            r = cnn_dist.run(model, method, P=4, steps=steps, k=2048, rows=5,
                             width=8192, width_kw=WIDTHS[model],
                             device=device)
            per[method] = {"losses": r.losses, "accs": r.accs, "d": r.d}
            print(f"{model:9s} {method:12s} loss {r.losses[0]:.4f} -> "
                  f"{r.losses[-1]:.4f}  acc {r.accs[-1]:.3f}", flush=True)
        results[model] = per
        gs = per["gs-sgd"]["losses"][-1]
        sk = per["sketched-sgd"]["losses"][-1]
        gt = per["gtopk"]["losses"][-1]
        print(f"{model}: gs-sgd {gs:.4f} vs sketched {sk:.4f} vs gtopk "
              f"{gt:.4f}  (claim: gs <= gt + 0.05: {gs <= gt + 0.05})",
              flush=True)
    results["device"] = cnn_dist.device_record(device)
    cnn_dist.write_json(results, "convergence.json", out)
    return results


if __name__ == "__main__":
    cnn_dist.cli(main, __doc__, steps=(int, 40))
