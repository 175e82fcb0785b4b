"""Inner CG iterations per Schur apply over the traced window: the
program's counter ``cg.iterations.schur_inner`` (``ops.cg``: the inner
solves of the forward applies and their adjoint solves in the backward)
over ``schur.applies`` (``ops.matern``)."""

from portbench.harness.registry import counter


def read(run):
    applies = counter("schur.applies")
    iterations = counter("cg.iterations.schur_inner")
    if not applies or iterations is None:
        return None
    return iterations / applies
