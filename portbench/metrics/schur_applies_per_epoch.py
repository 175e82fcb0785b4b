"""Applies of the Schur complement per training epoch over the traced
window: the program's counter ``schur.applies.<columns>``
(``ops.matern.make_schur_matvec``, one an apply of S, each running an inner
CG on the unlabeled block), summed over the widths, per epoch."""

from portbench.harness.readers import per_unit
from portbench.harness.registry import counter


def read(run):
    applies = counter("schur.applies")
    return None if applies is None else per_unit(applies, run)
