"""The descriptor suite of one grid, its rasters given: one call of
``pipeline.descriptor_suite``."""

import torch

from benchmark.reference import suite as ref


def run(program, x, traffic, probe):
    from descriptools_tpu_torch.pipeline import descriptor_suite

    probe.note("suite", fdr=x["fdr"], fac=x["fac"])
    with probe.span("suite"), probe.host("suite.enqueue"):
        return descriptor_suite(x["dem"], x["fdr"], x["fac"], x["river"], program.cfg)


def reference(x, pipeline, traffic, dtype=torch.float32, classify_dtype=torch.float64):
    out, steps = ref.suite(x["dem"], x["fdr"], x["fac"], x["river"], pipeline, dtype)
    return out, ref.walk_summary(steps, x["dem"], out["indices"])
