"""Index gathers and scatters of the Schur code per training epoch over the
traced window: the program's counter ``schur.gathers.<site>`` (one an
index gather or scatter: ``embed`` and ``select``, at the boundary of a
model's permuted stack or at every base apply of the index form,
``ops.matern.make_schur_matvec``), summed over the sites, per epoch."""

from portbench.harness.readers import per_unit
from portbench.harness.registry import counter


def read(run):
    gathers = counter("schur.gathers")
    return None if gathers is None else per_unit(gathers, run)
