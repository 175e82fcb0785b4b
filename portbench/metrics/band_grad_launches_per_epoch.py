"""K5 launches per training epoch over the traced window: the program's
counter ``dia.band_grad.<template>`` (``ops.dia``), summed over the
templates, per epoch: the DIA band cotangents of the backward passes. A
program without the counter (no K5) gives None."""

from portbench.harness.readers import per_unit
from portbench.harness.registry import counter


def read(run):
    launches = counter("dia.band_grad")
    return None if launches is None else per_unit(launches, run)
