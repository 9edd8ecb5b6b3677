"""One rank of the port's scale-out tests, on the CPU.

``python tests/torch_parallel_worker.py SUITE INPUTS OUT_DIR`` runs as one
of the ranks that :func:`spawn` starts through
``socceraction_tpu_torch.utils.env.run_distributed_workers`` (gloo). It reads the inputs its test wrote with ``torch.save``
(seeded numpy arrays, and parameters carried over from the JAX package),
runs every scenario of ``SUITE`` through the port's entry points, and
writes this rank's results to ``OUT_DIR/rank<r>.pt`` for the test to
check. It imports nothing of JAX.

- ``parallel`` (``tests/test_torch_parallel.py``): the ``('games',
  'model')`` mesh, sharded xT counts and fits, the train step from given
  parameters, ``train_distributed`` and ``sharded_rate``;
- ``sequence`` (``tests/test_torch_sequence_parallel.py``): the
  ``('games', 'seq')`` kernels of both action families.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist

from socceraction_tpu_torch import convert
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.core.batch import ActionBatch, AtomicActionBatch
from socceraction_tpu_torch.ml.mlp import MLPClassifier
from socceraction_tpu_torch.parallel import (
    make_mesh,
    make_sequence_mesh,
    make_train_step,
    sequence_features,
    sequence_labels,
    sequence_rate,
    sequence_values,
    shard_batch,
    shard_batch_seq,
    sharded_rate,
    sharded_xt_counts,
    sharded_xt_fit,
    sharded_xt_fit_matrix_free,
    train_distributed,
)
from socceraction_tpu_torch.parallel.vaep import gather_params
from socceraction_tpu_torch.utils.env import init_distributed, run_distributed_workers
from socceraction_tpu_torch.vaep.base import VAEP


#: Ranks of every spawn: a (2, 2) or (4, 1) mesh.
WORLD = 4
#: Seconds one spawn of the ranks may take, start to end.
SPAWN_TIMEOUT_S = 120.0


def spawn(suite: str, inputs: Dict[str, Any], tmp: Path) -> List[Dict[str, Any]]:
    """Run ``suite`` in ``WORLD`` gloo ranks of this script, on inputs
    saved under ``tmp`` (the file store too) -> each rank's results."""
    inp, out = tmp / 'inputs.pt', tmp / 'out'
    out.mkdir(parents=True)
    torch.save(inputs, inp)
    run_distributed_workers(
        __file__, WORLD, args=(suite, str(inp), str(out)), timeout_s=SPAWN_TIMEOUT_S,
        env={'OMP_NUM_THREADS': '1'}, store_dir=str(tmp),
    )
    return [torch.load(out / f'rank{r}.pt', weights_only=False) for r in range(WORLD)]


def batch_of(fields: Dict[str, Any], cls: type = ActionBatch) -> Any:
    return cls(**{name: torch.as_tensor(a) for name, a in fields.items()})


def model_of(heads: Dict[str, Any], cls: type = VAEP, **kwargs: Any) -> Any:
    """A port model from ``{head: (flax params, mean, std)}``."""
    models = {
        head: convert.mlp_from_jax_params(params, mean, std, device='cpu')
        for head, (params, mean, std) in heads.items()
    }
    return cls(models=models, device='cpu', **kwargs)


def error_of(fn: Callable[[], Any]) -> str:
    """The message of the ``ValueError`` ``fn`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ''


def flat_params(modules: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        f'{head}/{name}': t.detach().clone()
        for head, m in modules.items()
        for name, t in m.state_dict().items()
    }


def parallel_suite(inp: Dict[str, Any]) -> Dict[str, Any]:
    world = dist.get_world_size()
    batch = batch_of(inp['season'])
    mesh = make_mesh(model_parallel=inp['model_parallel'], device_type='cpu')
    out: Dict[str, Any] = {
        'mesh': dict(zip(mesh.mesh_dim_names, mesh.shape)),
        'coords': {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names},
        'error_divide': error_of(lambda: make_mesh(model_parallel=3, device_type='cpu')),
        'error_world': error_of(lambda: make_mesh(n_devices=world + 1, device_type='cpu')),
    }
    local = shard_batch(batch, mesh)
    out['shard'] = {'game_id': local.game_id, 'n_actions': local.n_actions, 'mask': local.mask}
    assert shard_batch(local, mesh) is local

    out['counts'] = sharded_xt_counts(batch, mesh, l=16, w=12)._asdict()
    grid, _, it = sharded_xt_fit(batch, mesh, l=16, w=12)
    out['fit'] = (grid, it)
    out['mf'] = sharded_xt_fit_matrix_free(batch, mesh, l=24, w=16)
    out['mf_groups'] = sharded_xt_fit_matrix_free(
        batch, mesh, l=24, w=16, group_id=torch.as_tensor(inp['group_id']),
        n_groups=inp['n_groups'],
    )

    names, hidden = inp['names'], inp['hidden']
    init_fn, step_fn, place = make_train_step(mesh, names, k=3, hidden=hidden)
    init = {head: convert.module_from_jax_params(p) for head, p in inp['init'].items()}
    params, opt = init_fn(0, inp['n_features'], params=init)
    losses = []
    for _ in range(2):
        params, opt, loss = step_fn(params, opt, place(batch))
        losses.append(loss)
    out['step_losses'] = torch.stack(losses)
    out['step_params'] = flat_params(gather_params(params, mesh, hidden))
    out['step_local'] = {h: [t.detach().clone() for t in ts] for h, ts in params.items()}

    models = train_distributed(batch, mesh, names, k=3, hidden=(16,), epochs=3)
    out['td_params'] = flat_params({h: m.module for h, m in models.items()})
    model = VAEP(xfns=names, nb_prev_actions=3, models=models, device='cpu')
    values, shard = sharded_rate(model, batch, mesh)
    out['td_values'] = values
    jmodel = model_of(inp['jax_models'], xfns=names, nb_prev_actions=3)
    out['jax_model_values'] = sharded_rate(jmodel, batch, mesh)[0]
    return out


def sequence_suite(inp: Dict[str, Any]) -> Dict[str, Any]:
    mesh = make_sequence_mesh(seq_parallel=inp['seq'], device_type='cpu')
    batch = batch_of(inp['standard'])
    atomic = batch_of(inp['atomic'], AtomicActionBatch)
    local = shard_batch_seq(batch, mesh)
    assert shard_batch_seq(local, mesh) is local
    out: Dict[str, Any] = {
        'coords': {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names},
        'error_seq_divide': error_of(lambda: make_sequence_mesh(seq_parallel=3, device_type='cpu')),
        'error_axis': error_of(lambda: shard_batch_seq(batch_of(inp['odd']), mesh)),
        'error_halo': error_of(
            lambda: sequence_labels(batch_of(inp['short']), mesh, nr_actions=10)
        ),
    }
    names, atomic_names = inp['names'], inp['atomic_names']
    for k in (1, 2, 3):
        out[f'features_k{k}'] = sequence_features(batch, mesh, names=names, k=k)
    out['goalscore'] = sequence_features(local, mesh, names=('goalscore',), k=1)
    for nr in (2, 10):
        out[f'labels_nr{nr}'] = torch.stack(sequence_labels(batch, mesh, nr_actions=nr))
    ps, pc = torch.as_tensor(inp['ps']), torch.as_tensor(inp['pc'])
    out['values'] = sequence_values(batch, ps, pc, mesh)
    for k in (1, 3):
        model = model_of(inp[f'models_k{k}'], nb_prev_actions=k)
        out[f'rate_k{k}'] = sequence_rate(model, batch, mesh)

    out['atomic_features'] = sequence_features(atomic, mesh, names=atomic_names, k=3)
    out['atomic_labels'] = torch.stack(sequence_labels(atomic, mesh))
    aps, apc = torch.as_tensor(inp['aps']), torch.as_tensor(inp['apc'])
    out['atomic_values'] = sequence_values(atomic, aps, apc, mesh)
    amodel = model_of(inp['atomic_models'], AtomicVAEP, nb_prev_actions=3)
    out['atomic_rate'] = sequence_rate(amodel, atomic, mesh)

    out['error_tree'] = error_of(lambda: sequence_rate(VAEP(device='cpu'), batch, mesh))
    clf = MLPClassifier(hidden=(4,), device='cpu')
    clf.module = convert.module_from_jax_params(inp['tiny_head'])
    clf.mean_, clf.std_ = torch.zeros(1), torch.ones(1)
    standard_model = VAEP(device='cpu')
    standard_model._models = {'scores': clf, 'concedes': clf}
    out['error_family'] = error_of(lambda: sequence_rate(standard_model, atomic, mesh))
    return out


SUITES = {'parallel': parallel_suite, 'sequence': sequence_suite}


def main() -> None:
    suite, inputs, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    rank, _ = init_distributed(device_type='cpu', timeout_s=120.0)
    inp = torch.load(inputs, weights_only=False)  # written by this rank's own test
    out = SUITES[suite](inp)
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
