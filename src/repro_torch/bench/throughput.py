"""Paper Table II: training throughput (images/s) on a 4-worker 1 GbE
cluster, and the speed-up ratios g/k (gs-SGD over gTop-k) and g/s (over
Sketched-SGD).

Port of ``benchmarks/throughput.py``. Throughput = global batch /
(t_compu + t_compr + t_commu), in two columns (``time_breakdown``):
'measured' takes t_compu and t_compr measured on the run's device (the
card unless ``--device cpu``), 'accel' the reference's accelerator model
(an assumed 50 TFLOP/s and 819 GB/s, not the card's). t_commu is the
paper's Eq. 1 at 1 GbE in both. The models are full size, the paper's
Table II scale (ResNet-20 width 16, d = 272,282; VGG-16 width 1, d =
14,724,042), at ``time_breakdown.paper_geometry``'s (k, W).

The paper's numbers: g/k = 1.3x (ResNet-20) / 3.1x (VGG-16), g/s =
1.1-1.2x. Nothing here asserts a ratio.

    python -m repro_torch.bench.throughput [--device cpu] [--out DIR]

writes ``throughput.json`` under ``experiments/bench_torch/``.
"""

from __future__ import annotations

from repro_torch.bench import cnn_dist
from repro_torch.bench.time_breakdown import breakdown

GLOBAL_BATCH = 32
METHODS = ("gtopk", "sketched-sgd", "gs-sgd")


def main(device=None, out: str | None = None,
         models=("resnet20", "vgg16"), width_kw: dict | None = None) -> dict:
    """``width_kw``: model -> width kwargs (default: full size)."""
    device = cnn_dist.prepare_device(device)
    results: dict = {}
    for model in models:
        per: dict = {}
        for method in METHODS:
            r = breakdown(model, method, device=device,
                          width_kw=(width_kw or {}).get(model))
            t_meas = r["t_compu"] + r["t_compr"] + r["t_commu"]
            t_model = r["t_compu_model"] + r["t_compr_model"] + r["t_commu"]
            per[method] = {"img_per_s": GLOBAL_BATCH / t_meas,
                           "img_per_s_accel": GLOBAL_BATCH / t_model, **r}
        for col in ("img_per_s", "img_per_s_accel"):
            per[f"speedup_vs_gtopk_{col}"] = (per["gs-sgd"][col]
                                              / per["gtopk"][col])
            per[f"speedup_vs_sketched_{col}"] = (per["gs-sgd"][col]
                                                 / per["sketched-sgd"][col])
        results[model] = per
        for col, label in (("img_per_s", f"measured ({device.type})"),
                           ("img_per_s_accel", "accel-modelled")):
            print(f"{model:9s} {label:16s} "
                  + "  ".join(f"{m} {per[m][col]:9.1f}" for m in METHODS)
                  + f"  g/k {per[f'speedup_vs_gtopk_{col}']:.3f}x  g/s "
                  f"{per[f'speedup_vs_sketched_{col}']:.3f}x  (paper: g/k "
                  "1.3-3.1x, g/s 1.1-1.2x)", flush=True)
    results["device"] = cnn_dist.device_record(device)
    cnn_dist.write_json(results, "throughput.json", out)
    return results


if __name__ == "__main__":
    cnn_dist.cli(main, __doc__)
