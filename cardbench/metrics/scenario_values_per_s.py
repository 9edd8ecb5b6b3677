"""scenario_values_per_s (values/s, host clock): perturbations times valid
actions of every counterfactual request whose values reached the host, over
the window's wall time."""

from cardbench.readers import throughput


def read(run):
    return throughput(run, 'values')
