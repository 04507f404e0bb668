"""The control of the comparison: the plain reference put in the program's
place and computed in the precision below the configurations' (bfloat16
for their float32 rasters, float32 for the float64 calibration).  Its
runs have to come out not correct; ``readings.py`` reads them."""

import torch


def control_job(spec):
    """A job function that runs the lower-precision reference instead of
    the program."""

    def job(program, x, traffic, probe):
        out, _ = spec.kind.reference(x, spec.pipeline, traffic, dtype=torch.bfloat16,
                                     classify_dtype=torch.float32)
        return out

    return job
