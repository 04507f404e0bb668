"""From a DEM to a class map: ``ops.terrain.derive_terrain``, the river
mask (``fac`` above the mix's ``river.fac_above``),
``pipeline.descriptor_suite``, and ``parallel.classify.sharded_classify_flood``
of HAND against the input's flood map, its threshold, Correctness and Fit
back on the host."""

import torch

from benchmark.reference import classify, terrain
from benchmark.reference import suite as ref


def run(program, x, traffic, probe):
    from descriptools_tpu_torch.ops.terrain import derive_terrain
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood
    from descriptools_tpu_torch.pipeline import descriptor_suite

    with probe.span("terrain"), probe.device("terrain"):
        fdr, fac = derive_terrain(x["dem"])
    with probe.span("river"):
        river = (fac > traffic["river"]["fac_above"]).to(torch.int8)
    probe.note("suite", fdr=fdr, fac=fac)
    with probe.span("suite"), probe.host("suite.enqueue"):
        out = descriptor_suite(x["dem"], fdr, fac, river, program.cfg)
    probe.sync()
    with probe.span("classify"), probe.host("classify"):
        th, correctness, fit, class_map = sharded_classify_flood(out["hand"], x["flood"])
    out.update(fdr=fdr, fac=fac, river=river, class_map=class_map,
               threshold=th, correctness=correctness, fit=fit)
    return out


def reference(x, pipeline, traffic, dtype=torch.float32, classify_dtype=torch.float64):
    fdr, fac = terrain.derive(x["dem"], dtype)
    river = (fac > traffic["river"]["fac_above"]).to(torch.int8)
    out, steps = ref.suite(x["dem"], fdr, fac, river, pipeline, dtype)
    th, correctness, fit, class_map = classify.classify_flood(out["hand"], x["flood"], classify_dtype)
    out.update(fdr=fdr, fac=fac, river=river, class_map=class_map,
               threshold=th, correctness=correctness, fit=fit)
    return out, ref.walk_summary(steps, x["dem"], out["indices"])
