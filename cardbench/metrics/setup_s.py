"""setup_s (s, host clock): process start to the first timed call: the port's
import, the kernels' build or load, the season and weights, the model, the
warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
