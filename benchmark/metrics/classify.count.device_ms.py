"""classify.count.device_ms (moves cells_per_s): device milliseconds a job
of the program's ``classify.count`` spans, the calibration's counting
passes (``stages.device_ms``); None where the program records none."""

from benchmark.stages import device_ms


def read(ctx):
    return device_ms(ctx, "classify.count")
