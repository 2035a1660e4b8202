"""Port parity: ``repro_torch.bench.comm_model.cell_model`` against
``benchmarks/comm_model.py``.

The model is configuration algebra, so the port's numbers must equal the
reference's field for field (floats with ``==``, the notes equal): in
every applicable (arch x shape x mesh) cell of ``ARCHS x SHAPES x
{single, multi}`` (64 cells) and under each option of ``train_cell`` and
``serve_cell`` (the cases ``tests/test_perf_opts.py`` exercises, plus the
bucketed, wire, compressor and gather-pass knobs).
"""

import dataclasses

import pytest

from benchmarks import comm_model as jcm
from repro.configs import ARCHS as J_ARCHS
from repro.configs import DP_MODE
from repro.configs.shapes import SHAPES, applicable
from repro.core.gs_sgd import MeshAxes as JMesh
from repro_torch.bench import comm_model as tcm
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.gs_sgd import MeshAxes as TMesh


def _mesh(kind):
    kw = dict(tp=16, data=16, tp_axis="model", data_axis="data")
    if kind == "multi":
        kw.update(pod=2, pod_axis="pod")
    return kw


CELLS = [(a, s, m) for m in ("single", "multi") for a in J_ARCHS
         for s in SHAPES if applicable(J_ARCHS[a], s)]


def _both(arch, shape, mesh, dp_mode=None, opts=None):
    dp_mode = dp_mode or DP_MODE[arch]
    j = jcm.cell_model(J_ARCHS[arch], shape, JMesh(**_mesh(mesh)), dp_mode,
                       None if opts is None else dict(opts))
    t = tcm.cell_model(T_ARCHS[arch], shape, TMesh(**_mesh(mesh)), dp_mode,
                       None if opts is None else dict(opts))
    return dataclasses.asdict(j), dataclasses.asdict(t)


def test_sixty_four_cells():
    assert len(CELLS) == 64


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=["__".join(c) for c in CELLS])
def test_cell_model_equals_reference(arch, shape, mesh):
    j, t = _both(arch, shape, mesh)
    assert t == j


WIRE = dict(k=65536, rows=5, width=2 ** 17, wire=2)
OPTION_CASES = [
    ("qwen3-4b", "train_4k", "single", "dp", {"parallel_block": True}),
    ("qwen3-4b", "train_4k", "multi", "dp", {"act_comm_factor": 0.25}),
    ("qwen3-4b", "prefill_32k", "single", "dp", {"act_comm_factor": 0.25}),
    ("qwen3-4b", "prefill_32k", "single", "dp", {"parallel_block": True}),
    ("qwen3-4b", "decode_32k", "single", "dp",
     {"parallel_block": True, "act_comm_factor": 0.25}),
    ("qwen3-moe-235b-a22b", "train_4k", "multi", "fsdp", {"microbatch": 2}),
    ("qwen3-moe-235b-a22b", "train_4k", "multi", "fsdp", {"microbatch": 8}),
    ("qwen3-moe-235b-a22b", "train_4k", "multi", "fsdp",
     {"microbatch": 8, "gather_passes": 2.0}),
    ("qwen3-4b", "train_4k", "multi", "dp", {"compressor": "dense"}),
    ("qwen3-4b", "train_4k", "multi", "dp", {"compressor": "gs-sgd"}),
    ("qwen3-4b", "train_4k", "single", "dp", {"compressor": "dense"}),
    ("qwen3-4b", "train_4k", "single", "dp", {"compressor": None}),
    ("yi-9b", "train_4k", "multi", "fsdp", {"compressor": "dense"}),
    ("qwen3-4b", "train_4k", "multi", "dp", {"sketch": WIRE}),
    ("qwen3-4b", "train_4k", "single", "dp",
     {"compressor_kw": dict(k=1000, rows=3, width=4096)}),
    ("qwen3-4b", "train_4k", "single", "dp", {"buckets": 4}),
    ("qwen3-4b", "train_4k", "multi", "dp", {"buckets": 8, "sketch": WIRE}),
    ("zamba2-2.7b", "train_4k", "single", "dp",
     {"buckets": 2, "parallel_block": True}),
    ("starcoder2-3b", "train_4k", "single", "dp",
     {"buckets": 4, "compressor": "sketched-sgd"}),
]


@pytest.mark.parametrize("arch,shape,mesh,dp_mode,opts", OPTION_CASES,
                         ids=[f"{c[0]}__{c[1]}__{c[2]}__{i}"
                              for i, c in enumerate(OPTION_CASES)])
def test_cell_model_options_equal_reference(arch, shape, mesh, dp_mode,
                                            opts):
    j, t = _both(arch, shape, mesh, dp_mode, opts)
    assert t == j
    if opts.get("buckets", 1) > 1 and opts.get("compressor",
                                               "gs-sgd") == "gs-sgd":
        assert any(n.startswith(f"bucketed x{opts['buckets']}")
                   for n in t["notes"]), t["notes"]
