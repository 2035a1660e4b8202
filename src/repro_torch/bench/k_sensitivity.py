"""Paper Figs. 6-7: convergence sensitivity to the sparsity k.

Port of ``benchmarks/k_sensitivity.py``. The paper finds a very small k
(10,000 of VGG-16's 15M, 0.07%) visibly damages convergence while a
moderate k does not; this sweeps k over the same relative range: gs-SGD,
P = 4, R = 5, W = 8,192, k in (64, 256, 1,024, 4,096), at ResNet-20
``width=8`` (or VGG-16 ``width_mult=0.25``).

    python -m repro_torch.bench.k_sensitivity [--device cpu] [--steps N]
        [--model resnet20|vgg16] [--out DIR]

writes ``k_sensitivity.json`` under ``experiments/bench_torch/``.
"""

from __future__ import annotations

from repro_torch.bench import cnn_dist
from repro_torch.bench.convergence import WIDTHS

KS = (64, 256, 1024, 4096)  # ~0.1% .. 6% of d


def main(steps: int = 40, model: str = "resnet20", device=None,
         out: str | None = None) -> dict:
    device = cnn_dist.prepare_device(device)
    results: dict = {}
    for k in KS:
        r = cnn_dist.run(model, "gs-sgd", P=4, steps=steps, k=k, rows=5,
                         width=8192, width_kw=WIDTHS[model], device=device)
        results[k] = {"losses": r.losses, "accs": r.accs, "d": r.d}
        print(f"{model} k={k:6d} (k/d={k / r.d:.4f}): loss "
              f"{r.losses[0]:.4f} -> {r.losses[-1]:.4f}", flush=True)
    small, big = results[KS[0]], results[KS[-1]]
    print(f"claim check: final loss k={KS[0]} ({small['losses'][-1]:.4f}) "
          f">= k={KS[-1]} ({big['losses'][-1]:.4f})", flush=True)
    doc = {str(k): v for k, v in results.items()}
    doc["device"] = cnn_dist.device_record(device)
    cnn_dist.write_json(doc, "k_sensitivity.json", out)
    return results


if __name__ == "__main__":
    cnn_dist.cli(main, __doc__, steps=(int, 40), model=(str, "resnet20"))
