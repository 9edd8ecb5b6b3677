"""rated_actions_per_s (actions/s, host clock): valid actions of every rating
call whose values reached the host, over the window's wall time."""

from cardbench.readers import throughput


def read(run):
    return throughput(run, 'actions')
