"""The port has every module of the JAX package, with the same ``__all__``.

Every module of ``socceraction_tpu`` has a counterpart at the same dotted
path in ``socceraction_tpu_torch``, except those :data:`SUBSTITUTES` names
with their reasons. Where a JAX module defines ``__all__``, its
counterpart's is the same list in the same order, less the names
:data:`JAX_ONLY` gives with their reasons, plus the port's own additions
:data:`PORT_ONLY` gives with theirs (ROADMAP.md, section C, lists both as
intended). A module or a name that differs any other way fails here.
"""

import importlib
import pkgutil

import pytest

import socceraction_tpu
import socceraction_tpu_torch

#: JAX module -> (its counterpart, or None, and why).
SUBSTITUTES = {
    'obs.xla': ('obs.dispatch', 'the compile observatory counts XLA compiles; the port compiles nothing '
                'through XLA and counts new dispatch signatures and nvcc builds instead'),
    'ops.compat': (None, 'a shim over jax versions (shard_map, axis_size); the port imports no jax'),
}

#: Modules only the port has, and why.
PORT_MODULES = {
    'convert': 'carries JAX checkpoints and parameters into PyTorch (flax msgpack, MLP params)',
    'device': "resolves the entry points' device: the card unless the caller asks for the CPU",
    'ops.cuda_build': 'builds and loads the hand-written CUDA kernels with nvcc',
    'ops.feature_rows': "writes the fused path's dense feature block and combined ids in one CUDA launch",
    'ops.seq_head': "runs a GRU sequence head's embedding, recurrence and readout in one CUDA launch",
    'parallel.collectives': 'torch.distributed collectives in place of the mesh collectives jax lowers',
}

_JIT = 'a jitted program or its XLA cost analysis; the port runs eager PyTorch and its own kernels'
_PALLAS = 'selects or runs the Pallas kernel or its XLA fallback; the port launches its CUDA kernel'

#: JAX module -> (names of its ``__all__`` the port does not export, why).
JAX_ONLY = {
    'obs': (('InstrumentedJit', 'cost_analysis', 'instrument_jit'), _JIT),
    'obs.xla': (('InstrumentedJit', 'cost_analysis', 'instrument_jit'), _JIT),
    'ops.fused': (('fused_pair_probs', 'PairDispatchPlan', 'pair_dispatch_plan'),
                  "the jitted serving dispatch and the plan its AOT exporter lowers; the port's models call "
                  'pair_probs_prepared and its warm tier ships built kernel libraries'),
    'ops.gather_matmul': (('CHUNK_ROWS', 'FUSED_KERNEL_METHODS', 'fused_kernel_method'), _PALLAS),
    'ops.profile': (('PALLAS_PROFILE_DEFAULTS', 'pallas_profile'), "the Pallas kernels' dispatch thresholds"),
    'ops.segment': (('segment_sum_pallas', 'segment_sum_xla'), _PALLAS),
    'utils': (('cpu_device_env',), 'sets up virtual XLA CPU devices for jax subprocesses'),
    'utils.env': (('cpu_device_env', 'run_distributed_cpu_workers'),
                  'virtual XLA CPU devices and jax.distributed CPU workers; the port spawns gloo ranks '
                  'with run_distributed_workers'),
}

#: Port module -> (names its ``__all__`` adds, why).
PORT_ONLY = {
    'atomic.vaep.base': (('XFNS_DEFAULT',), 'the default transformer names as a module constant'),
    'core': (('bucket_games', 'bucket_window', 'pack_row_values', 'pad_batch_games', 'synthetic_batch',
              'window_ladder'), "re-exports of core.batch's and core.synthetic's entry points"),
    'core.synthetic': (('synthetic_actions_frame',), 'the chain generator the JAX module defines but does '
                       'not export'),
    'learn': (('compare_heads', 'pack_replay_batch', 'replay_probs'), "re-exports of the loop's helpers"),
    'learn.gate': (('compare_heads',), 'the gate helper the JAX module defines but does not export'),
    'ml': (('AdamState', 'MLP'), 'the PyTorch MLP module and its optimizer state'),
    'ml.mlp': (('AdamState', 'MLP', 'adam_update', 'init_mlp'),
               "the PyTorch MLP, its Adam step and init, which flax and optax give the JAX package"),
    'obs': (('NAME_RE', 'InstrumentedFn', 'instrument'), "the metric name rule and the dispatch observatory's "
            'wrapper'),
    'obs.dispatch': (('InstrumentedFn', 'instrument', 'record_kernel_build', 'signature_diff'),
                     'the dispatch observatory: signatures and kernel builds in place of compiles'),
    'obs.coldstart': (('PHASES',), "the cold-start timeline's phase names"),
    'ops.atomic': (('ATOMIC_WIDTHS', 'vaep_core'), "the atomic feature widths and the formula's core"),
    'ops.features': (('kernel_width',), "a feature kernel's width"),
    'ops.fused': (('pair_probs_prepared', 'take_train_states'), "the serving fold's dispatch and the training "
                  "rows' gather"),
    'ops.gather_matmul': (('first_layer_cost', 'fused_first_layer_reference'),
                          "B1's analytic cost and its plain PyTorch version"),
    'ops.segment': (('launch_plan', 'segment_sum_cost', 'segment_sum_reference'),
                    "B2's launch plan, analytic cost and plain PyTorch version"),
    'parallel.mesh': (('ReplicaMesh', 'axis_group', 'axis_index', 'axis_size'),
                      'process groups in place of named mesh axes'),
    'parallel.vaep': (('gather_params',), "gathers a rank's parameters"),
    'pipeline.packed': (('copy_stream', 'hand_over'), "the feed's copy stream and its CUDA event hand-over"),
    'seq': (('SeqModule',), 'the PyTorch GRU module'),
    'seq.model': (('SeqModule', 'check_seq_layout'), 'the PyTorch GRU module and its layout check'),
    'utils.env': (('INIT_METHOD_ENV', 'init_distributed', 'run_distributed_workers'),
                  'torch.distributed start-up and the local rank gang'),
}


def _modules(package):
    """Every module of ``package`` by its path under the package ('' for the package)."""
    names = {''}
    for info in pkgutil.walk_packages(package.__path__, package.__name__ + '.'):
        names.add(info.name.split('.', 1)[1])
    return names


JAX_MODULES = sorted(_modules(socceraction_tpu))


def _import(package, path):
    return importlib.import_module(package + ('.' + path if path else ''))


def test_the_walk_sees_both_packages():
    assert {'data.wyscout.loader', 'data.opta.parsers.whoscored', 'obs.xla', 'ops.compat'} <= set(JAX_MODULES)
    assert {'data.wyscout.loader', 'data.opta.parsers.whoscored', 'obs.dispatch'} <= _modules(socceraction_tpu_torch)


@pytest.mark.parametrize('path', JAX_MODULES, ids=lambda p: p or '<package>')
def test_module_has_its_counterpart(path):
    target = SUBSTITUTES.get(path, (path, None))[0]
    if target is None:
        assert path not in _modules(socceraction_tpu_torch)
        return
    jax_mod, port_mod = _import('socceraction_tpu', path), _import('socceraction_tpu_torch', target)
    jax_all = getattr(jax_mod, '__all__', None)
    if jax_all is None:
        return
    assert hasattr(port_mod, '__all__'), f'{target} defines no __all__'
    jax_only = JAX_ONLY.get(path, ((), ''))[0]
    port_only = PORT_ONLY.get(target, ((), ''))[0]
    assert set(jax_only) <= set(jax_all) and set(port_only) <= set(port_mod.__all__)
    assert [n for n in port_mod.__all__ if n not in port_only] == [n for n in jax_all if n not in jax_only]
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), f'{target}.__all__ names {name}, which it lacks'


def test_the_port_adds_only_the_named_modules():
    substitutes = {target for target, _ in SUBSTITUTES.values() if target}
    assert _modules(socceraction_tpu_torch) - set(JAX_MODULES) - substitutes == set(PORT_MODULES)


def test_every_listed_difference_has_its_reason():
    for table in (JAX_ONLY, PORT_ONLY):
        for path, (names, reason) in table.items():
            assert names and reason, path
    assert all(reason for _, reason in SUBSTITUTES.values())
    assert all(PORT_MODULES.values())
    assert set(JAX_ONLY) <= set(JAX_MODULES)
    assert set(PORT_ONLY) <= _modules(socceraction_tpu_torch)


# -- public class members --------------------------------------------------------------

#: JAX class (its defining module under the package, and name) -> (public
#: members the port's class does not have as class members, why).
MEMBER_DIFFERENCES = {
    'ml.mlp.MLPClassifier': (('mean_', 'std_'), 'the standardization statistics are set on each instance '
                             'in the port, not declared on the class'),
    'seq.classifier.SeqClassifier': (('mean_', 'std_'), 'the standardization statistics are set on each '
                                     'instance in the port, not declared on the class'),
    'ops.fused.FusedRegistry': (('onehot_specs',), "an internal NamedTuple: the port's registry keeps its "
                                "one-hot blocks in other fields"),
    'ops.fused.PreparedPair': (('n_features', 'table_scale', 'total_nbytes', 'w_dense_scale'),
                               "an internal NamedTuple: the port's serving fold carries its int8 scales and "
                               'sizes in other fields'),
}


def _public_classes():
    """``{defining path: (JAX class, port class)}`` of every class a JAX
    ``__all__`` exports (the names :data:`JAX_ONLY` lists excepted)."""
    out = {}
    for path in JAX_MODULES:
        target = SUBSTITUTES.get(path, (path, None))[0]
        if target is None:
            continue
        jax_mod = _import('socceraction_tpu', path)
        port_mod = _import('socceraction_tpu_torch', target)
        for name in getattr(jax_mod, '__all__', ()):
            if name in JAX_ONLY.get(path, ((), ''))[0]:
                continue
            cls = getattr(jax_mod, name)
            if isinstance(cls, type):
                key = f"{cls.__module__.split('.', 1)[1]}.{cls.__qualname__}"
                out.setdefault(key, (cls, getattr(port_mod, name)))
    return out


PUBLIC_CLASSES = _public_classes()


def _members(cls):
    return {n for n in dir(cls) if not n.startswith('_')}


def test_the_class_walk_sees_the_exported_classes():
    assert {'core.batch.ActionBatch', 'core.batch.AtomicActionBatch', 'xthreat_v3.ExpectedThreatV3',
            'serve.service.RatingService', 'vaep.base.VAEP'} <= set(PUBLIC_CLASSES)
    assert set(MEMBER_DIFFERENCES) <= set(PUBLIC_CLASSES)


@pytest.mark.parametrize('key', sorted(PUBLIC_CLASSES))
def test_class_has_every_public_member(key):
    """Every public method, property and class attribute of the JAX class
    is a member of the port's, less :data:`MEMBER_DIFFERENCES`; a listed
    difference must still be one."""
    jax_cls, port_cls = PUBLIC_CLASSES[key]
    assert isinstance(port_cls, type), f'{key}: the port exports {port_cls!r}'
    listed = set(MEMBER_DIFFERENCES.get(key, ((), ''))[0])
    missing = _members(jax_cls) - _members(port_cls)
    assert missing == listed, f'{key}: missing {sorted(missing - listed)}, listed but present ' \
                              f'{sorted(listed - missing)}'
    assert listed <= _members(jax_cls)


def test_every_member_difference_has_its_reason():
    assert all(names and reason for names, reason in MEMBER_DIFFERENCES.values())


@pytest.mark.parametrize('backend', ['pandas', 'device'])
def test_expected_threat_predict_rates_as_rate(spadl_actions, backend):
    """``predict`` is ``rate``: on the golden game it gives ``rate``'s
    ratings, and the JAX class's ``predict`` (exactly on the numpy
    oracle, within 1e-5 on the device backends)."""
    import numpy as np

    from socceraction_tpu import xthreat as jxt
    from socceraction_tpu_torch import xthreat as txt

    assert txt.ExpectedThreat.predict is txt.ExpectedThreat.rate
    if backend == 'pandas':
        port, jax = txt.ExpectedThreat(backend='pandas'), jxt.ExpectedThreat(backend='pandas')
    else:
        port, jax = txt.ExpectedThreat(device='cpu'), jxt.ExpectedThreat(backend='jax')
    port.fit(spadl_actions)
    jax.fit(spadl_actions)
    got = port.predict(spadl_actions)
    np.testing.assert_array_equal(got, port.rate(spadl_actions))
    want = jax.predict(spadl_actions)
    if backend == 'pandas':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).any()


@pytest.mark.parametrize('cls_name', ['ActionBatch', 'AtomicActionBatch'])
def test_batch_replace_gives_the_fields_jax_gives(cls_name):
    """``replace`` on the port's batch and on the JAX package's, with the
    same new fields: the same class back, every field equal, the fields
    not named shared, the host count of the new lengths, and ``TypeError``
    for a name that is no field."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    import torch

    from socceraction_tpu import core as jcore
    from socceraction_tpu_torch import core as tcore

    rng = np.random.default_rng(21)
    G, A = 3, 8
    port_cls, jax_cls = getattr(tcore, cls_name), getattr(jcore, cls_name)

    def draw():
        cols = {}
        for f in dataclasses.fields(port_cls):
            shape = (G,) if f.name in ('n_actions', 'game_id') else (G, A)
            if f.name in ('is_home', 'mask'):
                cols[f.name] = rng.random(shape) < 0.5
            elif f.name in port_cls._float_fields:
                cols[f.name] = rng.normal(size=shape).astype(np.float32)
            else:
                cols[f.name] = rng.integers(0, A, size=shape).astype(np.int32)
        return cols

    cols, new = draw(), draw()
    named = {k: new[k] for k in ('type_id', 'n_actions', 'mask')}
    port = port_cls(**{k: torch.from_numpy(v) for k, v in cols.items()})
    jax = jax_cls(**{k: jnp.asarray(v) for k, v in cols.items()})
    got = port.replace(**{k: torch.from_numpy(v) for k, v in named.items()})
    want = jax.replace(**{k: jnp.asarray(v) for k, v in named.items()})
    assert type(got) is port_cls and type(want) is jax_cls
    for f in dataclasses.fields(port_cls):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)))
        if f.name not in named:
            assert getattr(got, f.name) is getattr(port, f.name)
    assert got.total_actions == int(new['n_actions'].sum()) == want.total_actions
    # a replacement that keeps the lengths keeps the host count
    assert port.replace(mask=got.mask).total_actions == port.total_actions
    with pytest.raises(TypeError):
        port.replace(no_such_field=1)
    with pytest.raises(TypeError):
        jax.replace(no_such_field=1)
