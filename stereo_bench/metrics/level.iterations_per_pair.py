"""level.iterations_per_pair: the iterations that the program's
early-exit levels ran over the window (``match.iterations_run()``, read
as the window opens and after it closes), over the pairs it served.
Nothing where the program has no such counter, or no level of the cell
exits early."""


def read(run):
    iterations = getattr(run, "iterations", None)
    if not iterations or not run.pairs:
        return None
    return iterations / run.pairs
