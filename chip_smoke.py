"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing
of JAX. Phases, one or more lines each; any failure raises and the script
exits non-zero:

1. card identity (``nvidia-smi`` name and power limit) and the f32
   precision settings (no TF32);
2. build every hand-written kernel from ``socceraction_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with its time, the plain version's time
   and its bound;
4. the VAEP path: ``VAEP.rate_batch`` on 512 games x 1664 actions with two
   (128, 128) heads (seeded random weights carried through
   ``convert.mlp_from_jax_params``), checked against the materialized
   reference, with each kernel's launch count; then bf16 and int8 serving
   against f32, and the synchronized f32 throughput;
5. the xT path on 3072 games x 1664 actions (5,111,808 actions, about the
   size of the full StatsBomb open data): four fits through the entry
   points (``ExpectedThreat`` 16 x 12 dense and 192 x 125 matrix-free, and
   20-group fleets through ``xt_counts``/``solve_xt`` at 16 x 12 and
   ``solve_xt_matrix_free`` at 192 x 125), each with its segment-sum
   launches, iterations, residual and wall time, and a profile of the
   192 x 125 fit; then the same fits on the CPU through the port's plain
   versions, which the card's must match (grids 1e-5, counts and
   probabilities 1e-6, iterations within one, ratings 1e-5);
6. the training path: B1 at the training shape (8192 rows, one 128-wide
   head) against its plain version, with the backward's parts timed;
   ``VAEP().fit_packed`` on 512 games x 1664 actions with (128, 128) heads,
   minibatches of 8192 and 3 epochs (the JAX package's bench
   configuration), its per-head epochs, losses, health and launch counts,
   and the trained model's ``rate_batch`` against its reference; the same
   fit on 64 games, on the card and on the CPU, held together (split,
   statistics, first-step gradient, every parameter within 1e-4), then
   fitted four more times on the card to show the fit reproducible, each
   repeat held to the CPU's within 1e-4; the same fit at the training
   rate 3e-4, twice on the card (card against card 0.0) and once on the
   CPU, and how far a planted fault in the backward's row sums moves the
   CPU's fit at each rate; and a profile of one training epoch;
7. Atomic-VAEP: ``AtomicVAEP().rate_batch`` on 512 games x 1664 atomic
   actions (a private seeded draw) with two (128, 128) heads, against its
   reference, bf16 and int8 against f32, B1's launch and the throughput;
   then ``AtomicVAEP().fit_packed`` on the same batch ((128, 128) heads,
   minibatches of 8192, 3 epochs) with its heads, launches and the trained
   model against its reference; a 64-game fit on the card and on the CPU,
   held together, and fitted once more on the card (card against card
   0.0);
8. the GRU sequence head: ``VAEP().fit_packed(learner='seq')`` on 512 x
   1664 actions at the default widths (32, 64, 64), minibatches of 8192, 3
   epochs, with its heads, B2's launches and a profile of one epoch; the
   trained model's ``rate_batch`` against its reference and its
   throughput; a 64-game seq fit on the card and on the CPU, held
   together, and once more on the card; a 64-game Atomic-VAEP seq fit on
   the card, rated against its reference.

Phase 3 also holds B1 at the atomic serving shape (R = 128, D = 46) and B2
at the atomic statistics shape to their plain versions.

Before the last line it prints one JSON object of kernel records
(``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from socceraction_tpu_torch.atomic.spadl import config as atomicconfig
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.convert import mlp_from_jax_params
from socceraction_tpu_torch.core.batch import ActionBatch, AtomicActionBatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.device import DeviceLike, resolve_device
from socceraction_tpu_torch.ml import mlp as mlp_mod
from socceraction_tpu_torch.ops import cuda_build
from socceraction_tpu_torch.ops import fused as fused_ops
from socceraction_tpu_torch.ops import gather_matmul as gm
from socceraction_tpu_torch.ops import segment as seg
from socceraction_tpu_torch.ops import xt as xtops
from socceraction_tpu_torch.ops.fused import train_layout
from socceraction_tpu_torch.vaep.base import VAEP, split_rows
from socceraction_tpu_torch.xthreat import ExpectedThreat

#: The serving batch: 512 games of 1664 actions (851,968 rows).
GAMES, ACTIONS = 512, 1664
#: The repo's default MLP head widths.
HIDDEN = (128, 128)
K = 3
#: Published H100 SXM peaks at a 700 W power limit: HBM bytes/s, f32
#: FLOP/s outside the tensor cores and dense TF32 FLOP/s on them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
#: The xT batch: 3072 games of 1664 actions (5,111,808 actions).
XT_GAMES = 3072
#: Groups of the xT fleet fits (``game_index % XT_GROUPS``).
XT_GROUPS = 20
#: Kernels this script builds.
KERNELS = ('gather_matmul', 'segment_sum')
#: The JAX package's bench training configuration: (128, 128) heads,
#: minibatches of 8192, 3 epochs, on the serving batch.
TRAIN_PARAMS = {'hidden': HIDDEN, 'batch_size': 8192, 'max_epochs': 3}
#: The card-against-CPU fit: 64 games (79,872 training rows, so the last
#: minibatch wraps), 2 epochs at a rate of 1e-4. At 3e-4 the fit is
#: chaotic at the bound's scale: Adam turns a near-cancelling gradient of
#: a rare one-hot column into a step of the whole rate, so the CPU's own
#: rounding (its BLAS library's code path, which differs from host to
#: host) can move the fit past 1e-4. Phase 6 also fits at 3e-4, on the
#: card twice, held card against card (:func:`rate_and_fault_fits`).
PARITY_GAMES = 64
PARITY_PARAMS = {**TRAIN_PARAMS, 'max_epochs': 2, 'learning_rate': 1e-4}
#: Further card fits of the parity batch, each compared with the first.
PARITY_REPEATS = 4
#: The sequence head's training configuration: the default widths
#: (embedding 32, GRU 64, readout 64), minibatches of 8192, 3 epochs.
SEQ_PARAMS = {'batch_size': 8192, 'max_epochs': 3}
SEQ_PARITY_PARAMS = {**SEQ_PARAMS, 'max_epochs': 2, 'learning_rate': 1e-4}
#: Shapes of B1 at serving: (combined-table rows, dense columns) per family.
SERVING_SHAPES = {'standard': (552, 55), 'atomic': (128, 46)}


def card_identity() -> str:
    """``nvidia-smi``'s name and power limit of the card, as one line."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def set_precision() -> str:
    """Full f32 matmuls everywhere (the parity contract rules out TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    return (
        f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
        f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} '
        f'float32_matmul_precision={torch.get_float32_matmul_precision()}'
    )


def time_ms(fn: Callable[[], Any], reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], Any], reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call, without the host's enqueue:
    ``reps`` calls captured in one CUDA graph, replayed between events.

    For calls of tens of microseconds, events around Python calls time the
    enqueue; a replayed graph launches its kernels back to back.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def first_layer_operands(
    device: torch.device, dtype: torch.dtype, n: int, seed: int = 0,
    k: int = K, r: int = 552, h: int = 2 * HIDDEN[0], d: int = 55,
) -> Tuple[torch.Tensor, ...]:
    """Random B1 operands at the serving shape, about 6% of ids set to -1."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, r, size=(n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.06] = -1

    def normal(shape: Tuple[int, ...], scale: float = 1.0) -> torch.Tensor:
        a = rng.normal(0, scale, size=shape).astype(np.float32)
        return torch.as_tensor(a, device=device)

    return (
        normal((k, r, h)).to(dtype),
        normal((d, h), d ** -0.5).to(dtype),
        normal((h,)),
        torch.as_tensor(ids, device=device),
        normal((n, d)),
    )


def first_layer_bound(operands: Tuple[torch.Tensor, ...]) -> Dict[str, Any]:
    """Least time (ms) one H100 needs for B1 on these inputs, and what bounds it.

    Bytes: every input read once, the output written once. Operations: the
    dense product as the kernel computes it, 3xTF32 on the tensor cores
    (three TF32 products of 2·N·D·H operations, two for a bf16 W, which is
    exact in TF32) at the TF32 rate, plus one f32 add per valid gathered
    element at the f32 rate. Beside it, the bytes the gathers move from L2
    (one table row element per valid id and column), which no design
    avoids while the tables do not fit on chip.
    """
    tables, w, bias, ids, x = operands
    _, r, h = tables.shape
    n, d = x.shape
    nbytes = sum(t.numel() * t.element_size() for t in operands) + n * h * 4
    valid = int(((ids >= 0) & (ids < r)).sum())
    products = 3 if tables.dtype == torch.float32 else 2
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (products * 2 * n * d * h / PEAK_TF32_FLOPS + valid * h / PEAK_F32_FLOPS) * 1e3
    return {
        'bound_ms': max(t_bytes, t_ops),
        'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
        'bytes_bound_ms': t_bytes,
        'ops_bound_ms': t_ops,
        'gather_bytes': valid * h * tables.element_size(),
    }


def check_first_layer(
    device: torch.device, dtype: torch.dtype, family: str = 'standard'
) -> Dict[str, Any]:
    """B1 against its plain version at a family's serving shape (phase 3)."""
    n = GAMES * ACTIONS
    r, d = SERVING_SHAPES[family]
    ops = first_layer_operands(device, dtype, n, r=r, d=d)
    gm.fused_first_layer_quant.plans = {}
    got = gm.fused_first_layer_quant(*ops)
    # the instantiation the kernel reported for this launch
    (plan,) = gm.fused_first_layer_quant.plans
    want = gm.fused_first_layer_reference(*ops)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    # relative error where it means something: away from zero outputs
    big = want.abs() >= 1e-2
    max_rel = float((diff[big] / want.abs()[big]).max())
    # atol 1e-4, rtol 1e-5: the kernel accumulates the dense product in
    # 3xTF32 on the tensor cores on top of the gathers, the plain version as
    # a separate f32 product, so the sums round apart
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    record = {
        'family': family,
        'shape': {'n': n, 'k': K, 'r': r, 'h': 2 * HIDDEN[0], 'd': d},
        'plan': plan,
        'dtype': str(dtype).replace('torch.', ''),
        'max_abs_err': max_abs,
        'max_rel_err': max_rel,
        'ms': graph_ms(lambda: gm.fused_first_layer_quant(*ops), reps=10),
        'plain_ms': time_ms(lambda: gm.fused_first_layer_reference(*ops), reps=5),
        **first_layer_bound(ops),
    }
    del ops, got, want, diff
    torch.cuda.empty_cache()
    return record


def main_path_first_layer(model: VAEP, batch: Any) -> Dict[str, Any]:
    """B1 timed on the operands ``rate_batch`` gives it (real ids, not
    uniform ones), captured from one more call outside the counted run."""
    ops = first_layer_operands_of(model, batch)
    tables, _, _, ids, _ = ops
    return {
        'shape': {'n': ids.shape[0], 'k': ids.shape[1], 'r': tables.shape[1], 'h': tables.shape[2],
                  'd': ops[4].shape[1], 'dtype': str(tables.dtype).replace('torch.', '')},
        'distinct_ids': int(torch.unique(ids).numel()),
        'ms': graph_ms(lambda: gm.fused_first_layer_quant(*ops), reps=10),
        **first_layer_bound(ops),
    }


def first_layer_operands_of(model: VAEP, batch: Any) -> Tuple[torch.Tensor, ...]:
    """The operands one ``rate_batch`` call hands B1."""
    captured: List[Tuple[torch.Tensor, ...]] = []
    launch = fused_ops.fused_first_layer_quant

    def capture(*args: torch.Tensor) -> torch.Tensor:
        captured.append(args)
        return launch(*args)

    fused_ops.fused_first_layer_quant = capture
    try:
        model.rate_batch(batch)
    finally:
        fused_ops.fused_first_layer_quant = launch
    return captured[0]


def atomic_batch(
    n_games: int, n_actions: int, *, seed: int = 0, device: DeviceLike = None
) -> AtomicActionBatch:
    """A seeded numpy draw of full Atomic-SPADL games on ``device``: types
    0 to 32 (passes, dribbles and receivals most often), bodyparts 0 to 3,
    periods 1 and 2, increasing times, locations on the pitch and
    displacements with some exact zeros."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    G, A = n_games, n_actions
    p = np.ones(len(atomicconfig.actiontypes))
    p[[atomicconfig.actiontypes.index(t) for t in ('pass', 'dribble', 'receival')]] = 8.0
    dx = rng.normal(0, 10, size=(G, A))
    dy = rng.normal(0, 6, size=(G, A))
    dx[rng.random((G, A)) < 0.1] = 0.0
    dy[rng.random((G, A)) < 0.1] = 0.0
    cols = {
        'type_id': rng.choice(len(p), size=(G, A), p=p / p.sum()),
        'bodypart_id': rng.integers(0, len(atomicconfig.bodyparts), size=(G, A)),
        'period_id': np.sort(rng.integers(1, 3, size=(G, A)), axis=1),
        'is_home': rng.integers(0, 2, size=(G, A)).astype(bool),
        'time_seconds': np.sort(rng.uniform(0, 2700, size=(G, A)), axis=1).astype(np.float32),
        'x': rng.uniform(0, atomicconfig.field_length, size=(G, A)).astype(np.float32),
        'y': rng.uniform(0, atomicconfig.field_width, size=(G, A)).astype(np.float32),
        'dx': dx.astype(np.float32),
        'dy': dy.astype(np.float32),
        'mask': np.ones((G, A), dtype=bool),
        'n_actions': np.full(G, A),
        'game_id': np.arange(G),
        'row_index': np.arange(G * A).reshape(G, A),
    }
    return AtomicActionBatch(**{
        n: torch.from_numpy(a.astype(np.int32) if a.dtype == np.int64 else a).to(dev)
        for n, a in cols.items()
    })


def make_batch(model_cls: Any, n_games: int, n_actions: int, *, seed: int, device: DeviceLike = None) -> Any:
    """A seeded batch of ``model_cls``'s action language."""
    draw = atomic_batch if model_cls is AtomicVAEP else synthetic_batch
    return draw(n_games, n_actions, seed=seed, device=device)


def make_model(
    device: DeviceLike = None, hidden: Tuple[int, ...] = HIDDEN, model_cls: Any = VAEP
) -> VAEP:
    """A ``model_cls`` (VAEP or AtomicVAEP) with two seeded random MLP
    heads, carried through the converter.

    Standardization statistics are numpy means/stds of the features of a
    small seeded batch. Two choices keep the heads like trained ones, so
    the quantized bands are measured where served values live: output
    biases sit at logit(0.01) (a goal within ten actions is a rare event),
    and the ``Dense_0`` row of a one-hot column is scaled by ``min(1, 2σ)``
    (a rarely active column gets few updates, so its weight on the raw
    0/1 input stays small instead of growing as ``1/σ``).
    """
    names = model_cls._default_xfns
    sample = model_cls._compute_features_kernel(
        make_batch(model_cls, 8, ACTIONS, seed=1, device=device), names=names, k=K
    )
    X = sample.reshape(-1, sample.shape[-1]).cpu().numpy()
    mean = X.mean(axis=0)
    std = X.std(axis=0)
    std = np.where(std > 0, std, 1.0).astype(np.float32)
    n_features = X.shape[1]
    layout = train_layout(names, K, fused_ops.REGISTRIES[model_cls._fused_registry])
    onehot = np.zeros(n_features, dtype=bool)
    for _, kind, off, width in layout.spans:
        onehot[off : off + width] = kind == 'onehot'
    row_scale = np.where(onehot, np.minimum(1.0, 2.0 * std), 1.0)[:, None]
    heads = {}
    for seed, col in enumerate(('scores', 'concedes')):
        rng = np.random.default_rng(100 + seed)
        widths = (n_features, *hidden, 1)
        layers = {}
        for i in range(len(widths) - 1):
            fan_in, fan_out = widths[i], widths[i + 1]
            last = i == len(widths) - 2
            kernel = rng.normal(0, (0.5 if last else 1.0) / np.sqrt(fan_in), (fan_in, fan_out))
            if i == 0:
                kernel = kernel * row_scale
            layers[f'Dense_{i}'] = {
                'kernel': kernel.astype(np.float32),
                'bias': (
                    np.full(fan_out, np.log(0.01 / 0.99)) if last
                    else rng.normal(0, 0.05, fan_out)
                ).astype(np.float32),
            }
        heads[col] = mlp_from_jax_params({'params': layers}, mean, std, device=device)
    return model_cls(models=heads, device=device)


def rate_main_path(model: VAEP, batch: Any) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Drive ``rate_batch`` once with every launch count zeroed just before
    and read just after, B1's also by the instantiation it reported
    (phase 4)."""
    gm.fused_first_layer_quant.launches = 0
    gm.fused_first_layer_quant.plans = {}
    values = model.rate_batch(batch)
    torch.cuda.synchronize()
    return values, {'gather_matmul': gm.fused_first_layer_quant.launches,
                    'gather_matmul_plans': dict(gm.fused_first_layer_quant.plans)}


def synced_rate_seconds(model: VAEP, batch: Any, reps: int = 5) -> float:
    """Median synchronized wall seconds of one ``rate_batch`` call."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.rate_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def check_against_reference(model: VAEP, batch: Any, values: torch.Tensor, label: str) -> float:
    """Raise unless ``values`` are finite and within 1e-5 of the model's
    reference rating of ``batch``; the largest difference."""
    ref = model.rate_batch_reference(batch)
    err = float((values - ref).abs().max())
    print(f'{label}: max |rate_batch - rate_batch_reference| = {err:.3e} (limit 1e-5)')
    if not (bool(torch.isfinite(values).all()) and err <= 1e-5):
        raise RuntimeError(f'{label}: rate_batch is {err} from its reference')
    return err


def serving_phase(model: VAEP, batch: Any, card: str, label: str) -> Dict[str, Any]:
    """Phases 4 and 7: ``rate_batch`` once with the launch count zeroed
    just before and read just after (one launch of B1), held to the
    reference; bf16 and int8 against f32; B1 on the operands ``rate_batch``
    gives it; the synchronized f32 throughput and a profile of one call."""
    values, launches = rate_main_path(model, batch)
    print(f'{label}: rate_batch {tuple(values.shape)}, launches {launches}')
    if launches['gather_matmul'] != 1:
        raise RuntimeError(f"{label}: rate_batch launched gather_matmul {launches['gather_matmul']} times, not once")
    if tuple(values.shape) != (batch.n_games, batch.max_actions, 3):
        raise RuntimeError(f'{label}: rate_batch values have shape {tuple(values.shape)}')
    check_against_reference(model, batch, values, label)
    for mode in ('bf16', 'int8'):
        model.set_quantize(mode)
        q = model.rate_batch(batch)
        q_err = float((q - values).abs().max())
        print(f'{label}: max |{mode} - f32| = {q_err:.3e} (limit 1e-3)')
        if not (bool(torch.isfinite(q).all()) and q_err <= 1e-3):
            raise RuntimeError(f'{label}: {mode} serving is outside the 1e-3 band: {q_err}')
    model.set_quantize('none')
    main_b1 = main_path_first_layer(model, batch)  # also rebuilds the f32 fold
    print(f"kernel gather_matmul on {label}'s operands ({card}): {json.dumps(main_b1)}")
    median = synced_rate_seconds(model, batch)
    n_actions = batch.total_actions
    print(
        f'{label}: f32 rate_batch {n_actions} actions, median {median * 1e3:.3f} ms, '
        f'{n_actions / median:.1f} actions/s ({card}); peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB'
    )
    prof = device_breakdown(lambda: model.rate_batch(batch))
    print(
        f"profile: one f32 rate_batch ({label}), {prof['wall_ms']:.3f} ms wall under the "
        f"profiler, {prof['kernel_ms']:.3f} ms of kernels ({card})"
    )
    for row in prof['top']:
        print(f'  profile: {json.dumps(row)}')
    return {'launches': launches, 'main_b1': main_b1, 'actions_per_s': n_actions / median}


def device_breakdown(fn: Callable[[], Any], top: int = 8) -> Dict[str, Any]:
    """Device time by kernel over one synchronized call of ``fn``.

    ``torch.profiler`` with CUDA activity; kernel rows are the events on
    the device. Returns the wall milliseconds under the profiler, the
    summed kernel milliseconds and launches, and the ``top`` kernels by
    device time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / 1e3, evt.count, evt.key[:90]))
    rows.sort(reverse=True)
    return {
        'wall_ms': wall_ms,
        'kernel_ms': sum(r[0] for r in rows),
        'kernel_calls': sum(r[1] for r in rows),
        'top': [{'ms': ms, 'calls': n, 'kernel': key} for ms, n, key in rows[:top]],
    }

def xt_fields(batch: ActionBatch) -> Tuple[torch.Tensor, ...]:
    """The seven batch fields the xT kernels read."""
    return (
        batch.type_id, batch.result_id,
        batch.start_x, batch.start_y, batch.end_x, batch.end_y,
        batch.mask,
    )


def group_ids(batch: ActionBatch, n_groups: int = XT_GROUPS) -> torch.Tensor:
    """``game_index % n_groups`` for every action slot, on the batch's device."""
    g = torch.arange(batch.n_games, dtype=torch.int32, device=batch.device) % n_groups
    return g[:, None].expand(batch.n_games, batch.max_actions).contiguous()


def segment_operands(batch: ActionBatch, seed: int = 3) -> List[Tuple[str, int, torch.Tensor, torch.Tensor, bool]]:
    """B2's operands at the xT path's shapes, from the xT batch.

    ``(label, S, values, ids, exact)``: the 16 x 12 shot counts (0/1
    values into 192 cells, held bitwise), and seeded real values on the
    successful moves (the matrix-free payoff's shape) into the 24,000
    cells of 192 x 125 and the 480,000 of its 20-group fleet.
    """
    f = xt_fields(batch)
    coarse = xtops._action_stream(*f, l=16, w=12)
    fine = xtops._action_stream(*f, l=192, w=125)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.random(fine.start_flat.numel(), dtype=np.float32), device=batch.device)
    real = u * fine.is_success_move.to(torch.float32)
    g = group_ids(batch).reshape(-1)
    return [
        ('16x12 shot counts', 192, coarse.is_shot.to(torch.float32), coarse.start_flat, True),
        ('192x125 payoff', 24000, real, fine.start_flat, False),
        ('192x125 x 20-group payoff', 480000, real, g * 24000 + fine.start_flat, False),
    ]


def check_segment_sum(label: str, s: int, vals: torch.Tensor, ids: torch.Tensor, exact: bool) -> Dict[str, Any]:
    """B2 against its plain version on the card at one shape (phase 3)."""
    got = seg.segment_sum(vals, ids, s)
    want = seg.segment_sum_reference(vals, ids, s)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    if exact:
        # integer-valued f32 sums are exact in any order
        if not torch.equal(got, want):
            raise RuntimeError(f'segment_sum {label}: counts differ from the plain version')
    else:
        # atomics add in another order than the plain version: atol/rtol 1e-5
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    ok = (ids >= 0) & (ids < s)
    ids_clean = torch.where(ok, ids, 0).long()
    vals_clean = torch.where(ok, vals, 0.0)
    n = vals.numel()
    bound_ms = (n * 8 + s * 4) / PEAK_BYTES_PER_S * 1e3
    return {
        'shape': label,
        'n': n,
        'segments': s,
        'exact': exact,
        'max_abs_err': max_abs,
        # device time (a replayed graph); beside it the old reading, events
        # around 50 Python calls, which can time the host's enqueue
        'ms': graph_ms(lambda: seg.segment_sum(vals, ids, s), reps=50),
        'event_ms': time_ms(lambda: seg.segment_sum(vals, ids, s), reps=50),
        'plain_ms': graph_ms(lambda: seg.segment_sum_reference(vals, ids, s), reps=20),
        # one PyTorch call computes the same function on ids already cleaned
        'library_ms': graph_ms(
            lambda: torch.zeros(s, device=vals.device).scatter_add_(0, ids_clean, vals_clean),
            reps=50,
        ),
        'bound_ms': bound_ms,
        'bound_by': 'bytes',
        'plan': seg.launch_plan(n, s),
    }


def _np(t: Any) -> Any:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _timed_fit(device: torch.device, fn: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    """Run one fit with the segment-sum count zeroed just before and read
    just after, synchronized, with its wall time."""
    if device.type == 'cuda':
        torch.cuda.synchronize()
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    out = fn()
    if device.type == 'cuda':
        torch.cuda.synchronize()
    out['wall_s'] = time.perf_counter() - t0
    out['launches'] = seg.segment_sum.launches
    return out


def xt_fits(batch: ActionBatch, device: DeviceLike = None) -> Dict[str, Dict[str, Any]]:
    """The four xT fits through the entry points (phase 5), on ``device``.

    Each result holds host copies of the grid(s), the certificate, the
    counts or probabilities, the ratings of the whole batch, the wall time
    and the segment-sum launches of that fit alone.
    """
    dev = batch.device if device is None else torch.device(device)
    fields = xt_fields(batch)
    gid = group_ids(batch)

    def model_fit(**kw: Any) -> Callable[[], Dict[str, Any]]:
        def run() -> Dict[str, Any]:
            m = ExpectedThreat(device=device, **kw).fit(batch)
            return {
                'solver': m.solver,
                'grid': m.xT,
                'iterations': np.asarray(m.n_iter),
                'residual': m.solve_residual,
                'converged': np.asarray(m.converged),
                'probs': {
                    'p_score': m.scoring_prob_matrix,
                    'p_shot': m.shot_prob_matrix,
                    'p_move': m.move_prob_matrix,
                    **({} if m.transition_matrix is None else {'transition': m.transition_matrix}),
                },
                'counts': {},
                'rate': m.rate(batch),
            }
        return run

    def fleet_dense() -> Dict[str, Any]:
        counts = xtops.xt_counts(*fields, l=16, w=12, group_id=gid, n_groups=XT_GROUPS)
        probs = xtops.xt_probabilities(counts, l=16, w=12)
        sol = xtops.solve_xt(probs)
        return _fleet_record('dense', sol, probs, counts, fields, gid, 16, 12)

    def fleet_matrix_free() -> Dict[str, Any]:
        sol, probs = xtops.solve_xt_matrix_free(
            *fields, l=192, w=125, group_id=gid, n_groups=XT_GROUPS
        )
        return _fleet_record('matrix-free', sol, probs, None, fields, gid, 192, 125)

    return {
        'ExpectedThreat 16x12': _timed_fit(dev, model_fit()),
        'ExpectedThreat 192x125': _timed_fit(dev, model_fit(l=192, w=125)),
        f'xt_counts/solve_xt 16x12 x {XT_GROUPS} groups': _timed_fit(dev, fleet_dense),
        f'solve_xt_matrix_free 192x125 x {XT_GROUPS} groups': _timed_fit(dev, fleet_matrix_free),
    }


def _fleet_record(
    solver: str, sol: Any, probs: Any, counts: Any, fields: Tuple[torch.Tensor, ...],
    gid: torch.Tensor, l: int, w: int,
) -> Dict[str, Any]:
    rate = xtops.rate_actions(sol.grid, *fields, l=l, w=w, group_id=gid)
    return {
        'solver': solver,
        'grid': _np(sol.grid),
        'iterations': _np(sol.iterations),
        'residual': float(sol.residual.max()),
        'converged': _np(sol.converged),
        'probs': {
            k: _np(v) for k, v in probs._asdict().items() if v is not None
        },
        'counts': {} if counts is None else {k: _np(v) for k, v in counts._asdict().items()},
        'rate': _np(rate),
    }


def compare_fits(card: Dict[str, Dict[str, Any]], cpu: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Hold every card fit to the CPU fit of the same inputs; raise on any miss.

    Grids within 1e-5 (the sweep's sums run in another order), counts and
    probabilities within 1e-6 (counts are exact in any order), iterations
    within one sweep (a residual at ``eps`` may exit one sweep apart), and
    ratings within 1e-5 with their NaNs in the same places.
    """
    report = {}
    for name, a in card.items():
        b = cpu[name]
        if not (np.asarray(a['converged']).all() and np.isfinite(a['grid']).all()):
            raise RuntimeError(f'{name}: the card fit did not converge to a finite grid')
        if a['grid'].shape != b['grid'].shape:
            raise RuntimeError(f'{name}: grid shape {a["grid"].shape} != {b["grid"].shape}')
        err = {'grid': float(np.abs(a['grid'] - b['grid']).max())}
        for group in ('counts', 'probs'):
            for k in a[group]:
                err[k] = float(np.abs(np.asarray(a[group][k], np.float64) - b[group][k]).max())
        it_gap = int(np.abs(a['iterations'].astype(np.int64) - b['iterations']).max())
        nan_a, nan_b = np.isnan(a['rate']), np.isnan(b['rate'])
        if not np.array_equal(nan_a, nan_b):
            raise RuntimeError(f'{name}: rated actions differ between the card and the CPU')
        err['rate'] = float(np.abs(a['rate'][~nan_a] - b['rate'][~nan_b]).max(initial=0.0))
        limits = {k: 1e-5 if k in ('grid', 'rate') else 1e-6 for k in err}
        bad = {k: v for k, v in err.items() if not v <= limits[k]}
        if bad or it_gap > 1:
            raise RuntimeError(f'{name}: card vs CPU outside limits: {bad}, iterations gap {it_gap}')
        report[name] = {**err, 'iterations_gap': it_gap}
    return report


def xt_summary(fit: Dict[str, Any]) -> Dict[str, Any]:
    """The printed line of one fit."""
    its = np.asarray(fit['iterations'])
    return {
        'solver': fit['solver'],
        'iterations': int(its) if its.ndim == 0 else its.tolist(),
        'residual': fit['residual'],
        'wall_s': fit['wall_s'],
        'segment_sum_launches': fit['launches'],
    }


# -- the training path -----------------------------------------------------------


def check_training_first_layer(device: torch.device, family: str = 'standard') -> Dict[str, Any]:
    """B1 at a family's training shape (one minibatch of 8192 rows, one
    128-wide head) against its plain version, and the backward's parts,
    each timed as a replayed graph (phases 6 and 7)."""
    n, h = TRAIN_PARAMS['batch_size'], HIDDEN[0]
    r, d = SERVING_SHAPES[family]
    ops = first_layer_operands(device, torch.float32, n, seed=4, h=h, r=r, d=d)
    tables, w, _, ids, x = ops
    got = gm.fused_first_layer_quant(*ops)
    want = gm.fused_first_layer_reference(*ops)
    torch.cuda.synchronize()
    # as at the serving shape: 3xTF32 on the tensor cores against an f32 product
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    g = torch.randn((n, h), generator=torch.Generator().manual_seed(5)).to(device)
    k = ids.shape[1]
    rows_bytes = n * h * 4 + n * 4 + r * h * 4
    parts = {
        # one table's cotangent; a step runs k of them
        'segment_sum_rows': graph_ms(lambda: seg.segment_sum_rows(g, ids[:, 0], r), reps=50),
        'd_w = x.T @ g': graph_ms(lambda: x.t() @ g, reps=50),
        'd_bias = g.sum(0)': graph_ms(lambda: g.sum(0), reps=50),
        # not run in training (x_dense is data), timed for the record
        'd_x = g @ W.T': graph_ms(lambda: g @ w.t(), reps=50),
    }
    return {
        'shape': {'n': n, 'k': k, 'r': r, 'h': h, 'd': x.shape[1], 'dtype': 'float32'},
        'max_abs_err': float((got - want).abs().max()),
        'ms': graph_ms(lambda: gm.fused_first_layer_quant(*ops), reps=50),
        'plain_ms': graph_ms(lambda: gm.fused_first_layer_reference(*ops), reps=20),
        **first_layer_bound(ops),
        'backward_ms': parts,
        'backward_step_ms': k * parts['segment_sum_rows'] + parts['d_w = x.T @ g'] + parts['d_bias = g.sum(0)'],
        'segment_sum_rows_bytes_bound_ms': rows_bytes / PEAK_BYTES_PER_S * 1e3,
    }


def fit_vaep(
    batch: Any, params: Dict[str, Any], device: DeviceLike = None, *,
    model_cls: Any = VAEP, learner: str = 'mlp',
) -> Dict[str, Any]:
    """``model_cls(device).fit_packed(batch, learner, tree_params=params,
    random_state=0)`` with both kernels' counts zeroed just before and read
    just after, synchronized, with its wall time and a record per head
    (phases 6 to 8)."""
    dev = batch.device
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    model = model_cls(device=device).fit_packed(
        batch, learner=learner, tree_params=params, random_state=0
    )
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        'gather_matmul': gm.fused_first_layer_quant.launches,
        'segment_sum': seg.segment_sum.launches,
    }
    n_train = len(split_rows(batch.n_games * batch.max_actions, 0.25, 0)[0])
    steps = -(-n_train // params['batch_size'])
    heads = {}
    for col, clf in model._models.items():
        health = clf.train_health_
        heads[col] = {
            'epochs': health['epochs'],
            'steps_per_epoch': steps,
            'epoch_s': health['epoch_seconds'],
            'trained_actions_per_s': [n_train / sec for sec in health['epoch_seconds']],
            'epoch_losses': health['epoch_losses'],
            'val_losses': health['val_losses'],
            'health': {k: v for k, v in health.items()
                       if k not in ('epoch_seconds', 'epoch_losses', 'val_losses')},
        }
    return {'model': model, 'batch': batch, 'learner': learner, 'wall_s': wall,
            'launches': launches, 'n_train': n_train, 'steps_per_epoch': steps, 'heads': heads}


def stats_launches(model: VAEP) -> int:
    """B2 launches of one statistics pass: a histogram per state, then one
    per state and one-hot block."""
    layout = train_layout(model.xfns, model.nb_prev_actions, model._registry)
    blocks = sum(kind == 'onehot' for _, kind, _, _ in layout.spans)
    return layout.k * (1 + blocks)


def check_fit(run: Dict[str, Any], params: Dict[str, Any]) -> None:
    """Raise unless every head trained with finite health and a loss that
    fell from the first epoch to the last, and, on the card, B2 launched
    for the statistics and B1 on every step of an MLP fit (none of a seq
    fit)."""
    steps = 0
    for col, head in run['heads'].items():
        health, losses = head['health'], head['epoch_losses']
        if not health['finite']:
            raise RuntimeError(f'head {col!r} trained to non-finite health: {health}')
        if not losses[-1] < losses[0]:
            raise RuntimeError(f'head {col!r}: the training loss did not fall: {losses}')
        steps += head['epochs'] * head['steps_per_epoch']
    if run['batch'].device.type != 'cuda':
        return  # the plain versions launch nothing
    b1 = run['launches']['gather_matmul']
    if (b1 < steps) if run['learner'] == 'mlp' else (b1 != 0):
        raise RuntimeError(f"fit_packed({run['learner']!r}) launched gather_matmul {b1} times for {steps} training steps")
    want = stats_launches(run['model'])
    if run['launches']['segment_sum'] != want:
        raise RuntimeError(f"the statistics pass launched segment_sum {run['launches']['segment_sum']} times, not {want}")


def head_trainer(model: VAEP, data: Any, params: Dict[str, Any]) -> Tuple[Any, Dict[str, torch.Tensor], Any]:
    """A fresh scores head's epoch trainer, the rows it trains on and its
    module, with the fitted model's statistics: a classifier of the same
    class and seed starts from the same weights and draws the same
    permutations."""
    head = model._models['scores']
    clf = type(head)(**params, device=model.device)
    module, rows, loss_fn, _, _, _ = clf._packed_problem(
        (data.train, data.layout), data.y_train['scores'], names=model.xfns,
        k=model.nb_prev_actions, registry=model._fused_registry, mean=head.mean_, std=head.std_,
    )
    module.requires_grad_(True)
    trainer = mlp_mod._EpochTrainer(
        loss_fn, list(module.parameters()), int(data.train.weight.shape[0]),
        clf.batch_size, clf.seed, clf.learning_rate,
    )
    return trainer, rows, module


def first_step_gradients(
    model: VAEP, data: Any, params: Dict[str, Any], relu_mask_of: Optional[np.ndarray] = None
) -> Tuple[Dict[str, np.ndarray], Any]:
    """The gradient of the scores head's first training step, and for an
    MLP head the step's first-layer pre-activations (else ``None``).

    With ``relu_mask_of`` (another device's pre-activations of the same
    step), every pre-activation whose sign differs from it takes its
    value, with the gradient of the own one: the step then passes the
    first ReLU with that device's mask.
    """
    trainer, rows, module = head_trainer(model, data, params)
    idx = trainer._permutation(0)[trainer.slot_pos[: trainer.batch_size]]
    first_layer = fused_ops.fused_first_layer
    pre: List[torch.Tensor] = []

    def capture(*args: torch.Tensor) -> torch.Tensor:
        h = first_layer(*args)
        pre.append(h)
        if relu_mask_of is None:
            return h
        other = torch.as_tensor(relu_mask_of, device=h.device)
        return torch.where((h > 0) != (other > 0), h - h.detach() + other, h)

    fused_ops.fused_first_layer = capture
    try:
        loss = trainer.loss_fn({name: t.index_select(0, idx) for name, t in rows.items()},
                               trainer.slot_weight[0])
    finally:
        fused_ops.fused_first_layer = first_layer
    grads = torch.autograd.grad(loss, trainer.params)
    named = {name: _np(g) for (name, _), g in zip(module.named_parameters(), grads)}
    return named, _np(pre[0]) if pre else None


def max_param_gap(a: VAEP, b: VAEP, col: str) -> float:
    """The largest difference of one head's parameters in two models."""
    return max(
        float((p - q.to(p.device)).abs().max())
        for p, q in zip(a._models[col].module.parameters(), b._models[col].module.parameters())
    )


def compare_training(card: Dict[str, Any], cpu: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """Hold the card's fit to the CPU's on the same batch; raise on any miss.

    Splits identical (rows, ids, weights, labels; the packed dense columns
    within 1e-5, the feature kernels' trigonometry rounds apart on the
    card); statistics with std within rtol 1e-6 and the mean within 1e-6
    of max(|mean|, std); the first step's gradient within 1e-5 of its
    largest entry per parameter; every trained parameter within 1e-4, the
    JAX package's own training-parity bound. B1 on the card and its
    plain version on the CPU round the first layer's pre-activations apart
    (within B1's atol 1e-4), so one that sits that close to zero may take
    the other side of the ReLU and move its row's gradient by a whole
    term: the CPU's gradient is taken with the card's ReLU mask, every
    flip must be within 1e-4 of zero, and every parameter's gradient is
    then held to 1e-5.
    """
    a, b = card['model'], cpu['model']
    batch_a, batch_b = card['batch'], cpu['batch']
    da = a.training_set(batch_a, 0.25, 0)
    db = b.training_set(batch_b, 0.25, 0)
    if not (np.array_equal(da.train_rows, db.train_rows) and np.array_equal(da.val_rows, db.val_rows)):
        raise RuntimeError('the card and the CPU split the rows differently')
    for name in ('combo_ids', 'weight'):
        if not np.array_equal(_np(getattr(da.train, name)), _np(getattr(db.train, name))):
            raise RuntimeError(f'packed training {name} differ between the card and the CPU')
    for col in da.y_train:
        if not np.array_equal(_np(da.y_train[col]), _np(db.y_train[col])):
            raise RuntimeError(f'{col} labels differ between the card and the CPU')
    x_err = float(np.abs(_np(da.train.x_dense) - _np(db.train.x_dense)).max())
    report: Dict[str, Any] = {'x_dense': x_err}
    if not x_err <= 1e-5:
        raise RuntimeError(f'packed dense columns differ by {x_err}')
    for col in a._models:
        ha, hb = a._models[col], b._models[col]
        mean_a, mean_b = _np(ha.mean_).astype(np.float64), _np(hb.mean_).astype(np.float64)
        std_a, std_b = _np(ha.std_).astype(np.float64), _np(hb.std_).astype(np.float64)
        std_rel = float((np.abs(std_a - std_b) / std_b).max())
        mean_rel = float((np.abs(mean_a - mean_b) / np.maximum(np.abs(mean_b), std_b)).max())
        if not (std_rel <= 1e-6 and mean_rel <= 1e-6):
            raise RuntimeError(f'{col} statistics: std {std_rel}, mean {mean_rel} relative')
        gaps = {
            name: float((p - q.to(p.device)).abs().max())
            for (name, p), q in zip(ha.module.named_parameters(), hb.module.parameters())
        }
        worst = max(gaps, key=gaps.get)
        report[col] = {'std_rel': std_rel, 'mean_rel': mean_rel, 'param_gap': gaps[worst],
                       'param_gap_at': worst, 'param_gaps': gaps}
        if isinstance(ha, mlp_mod.MLPClassifier):
            # where in the first layer: the feature column, its kind and its
            # mean (a one-hot column's activation frequency)
            w_gap = (ha.module.Dense_0.weight - hb.module.Dense_0.weight.to(ha.device)).abs()
            unit, column = divmod(int(w_gap.argmax()), w_gap.shape[1])
            kind = next(kd for _, kd, off, width in da.layout.spans if off <= column < off + width)
            report[col]['dense_0_gap_at'] = {'unit': unit, 'column': column, 'kind': kind,
                                             'column_mean': float(mean_b[column])}
        if not gaps[worst] <= 1e-4:
            raise RuntimeError(f'{col}: card and CPU parameters differ by {gaps[worst]} at {worst}: {gaps}')
    ga, ha = first_step_gradients(a, da, params)
    gb, hb = first_step_gradients(b, db, params, relu_mask_of=ha)
    if ha is not None:
        flipped = (ha > 0) != (hb > 0)
        flip_h = float(np.maximum(np.abs(ha), np.abs(hb))[flipped].max(initial=0.0))
        report['first_layer'] = {
            'max_abs_diff': float(np.abs(ha - hb).max()), 'relu_flips': int(flipped.sum()),
            'relu_flip_max_abs': flip_h,
        }
        if not flip_h <= 1e-4:
            raise RuntimeError(f'a first-layer pre-activation of {flip_h} changed sign: {report["first_layer"]}')
    grad_rel = {
        name: float(np.abs(ga[name] - gb[name]).max() / max(np.abs(gb[name]).max(), 1e-30))
        for name in ga
    }
    report['first_step_grad_rel'] = grad_rel
    if not max(grad_rel.values()) <= 1e-5:
        raise RuntimeError(f'first-step gradients differ: {grad_rel}')
    return report


def parity_fits(
    pbatch: Any, params: Dict[str, Any], label: str, repeats: int, **fit: Any
) -> Dict[str, Any]:
    """A 64-game fit on the card and on the CPU, held together
    (:func:`compare_training`), then ``repeats`` more card fits, each held
    to the CPU's within 1e-4 and compared with the first card fit."""
    card_run = fit_vaep(pbatch, params, **fit)
    check_fit(card_run, params)
    t0 = time.perf_counter()
    cpu_run = fit_vaep(pbatch.to('cpu'), params, 'cpu', **fit)
    print(f'{label} (CPU, plain versions): fit_packed in {time.perf_counter() - t0:.1f} s')
    check_fit(cpu_run, params)
    parity = compare_training(card_run, cpu_run, params)
    print(
        f"{label}: card vs CPU ({pbatch.n_games} games, {card_run['n_train']} training rows, "
        f"{json.dumps(params)}): {json.dumps(parity)}"
    )
    # the card's fit is reproducible (no atomics in the training step):
    # the same fit is repeated, and every repeat held to the CPU's too
    gaps = {col: {'card_vs_cpu': [parity[col]['param_gap']], 'card_vs_card': []}
            for col in card_run['model']._models}
    for _ in range(repeats):
        repeat = fit_vaep(pbatch, params, **fit)['model']
        for col, g in gaps.items():
            g['card_vs_cpu'].append(max_param_gap(repeat, cpu_run['model'], col))
            g['card_vs_card'].append(max_param_gap(repeat, card_run['model'], col))
            if not g['card_vs_cpu'][-1] <= 1e-4:
                raise RuntimeError(f"{label}, {col}: a repeated card fit is {g['card_vs_cpu'][-1]} from the CPU's")
        del repeat
    print(
        f'{label}: the card fit {1 + repeats} times, max parameter gap per fit '
        f"(the first fit is card_vs_card's reference): {json.dumps(gaps)}"
    )
    return {'card_run': card_run, 'cpu_run': cpu_run, 'parity': parity, 'gaps': gaps}


def dropped_last_row(rows: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """``segment_sum_rows`` with a planted fault: each call's last row is
    left out of the sums (phase 6 measures how far the fault moves a fit)."""
    return lambda values, ids, n: rows(values[:-1], ids[:-1], n)


def rate_and_fault_fits(pbatch: Any, parity: Dict[str, Any], label: str) -> Dict[str, Any]:
    """Phase 6, beside the parity fits at ``PARITY_PARAMS``' rate 1e-4:

    - the same fit at the training rate 3e-4 twice on the card, the second
      held to the first (card against card 0.0), and once on the CPU,
      reported beside them (at that rate the CPU's own sums, in another
      BLAS order, can move the fit past 1e-4: no bound);
    - the reach of a planted fault at both rates: a CPU fit whose
      first-layer backward leaves each minibatch's last row out of the
      table row sums, against the clean CPU fit of the same rate.
    """
    fast = {**PARITY_PARAMS, 'learning_rate': 3e-4}
    first = fit_vaep(pbatch, fast)['model']
    again = fit_vaep(pbatch, fast)['model']
    cpu_batch = pbatch.to('cpu')
    cpu = {1e-4: parity['cpu_run']['model'], 3e-4: fit_vaep(cpu_batch, fast, 'cpu')['model']}
    rows = gm.segment_sum_rows
    gm.segment_sum_rows = dropped_last_row(rows)
    try:
        faulty = {lr: fit_vaep(cpu_batch, {**PARITY_PARAMS, 'learning_rate': lr}, 'cpu')['model']
                  for lr in cpu}
    finally:
        gm.segment_sum_rows = rows
    report: Dict[str, Any] = {}
    for col in first._models:
        report[col] = {
            'card_vs_card_3e-4': max_param_gap(again, first, col),
            'card_vs_cpu_3e-4': max_param_gap(first, cpu[3e-4], col),
            **{f'planted_fault_{lr:g}': max_param_gap(faulty[lr], cpu[lr], col) for lr in cpu},
        }
        if report[col]['card_vs_card_3e-4'] != 0.0:
            raise RuntimeError(f'{label}, {col}: two card fits at rate 3e-4 differ: {report[col]}')
    print(f'{label}: the parity fit at rate 3e-4, and a planted fault (a row left out of the '
          f'table row sums) at both rates, max parameter gap per head: {json.dumps(report)}')
    return report


def profile_epoch(model: VAEP, batch: Any, params: Dict[str, Any]) -> Dict[str, Any]:
    """``torch.profiler`` over one training epoch of a fresh scores head on
    the batch's training rows (no eval), after one warm-up epoch."""
    trainer, rows, _ = head_trainer(model, model.training_set(batch, 0.25, 0), params)
    state = mlp_mod.AdamState.zeros(trainer.params)
    state, _, _ = trainer.run(state, 0, rows)
    prof = device_breakdown(lambda: trainer.run(state, 1, rows), top=12)
    prof['steps'] = trainer.steps
    prof['launches_per_step'] = prof['kernel_calls'] / trainer.steps
    prof['idle_share'] = 1.0 - prof['kernel_ms'] / prof['wall_ms']
    return prof


def training_phase(
    batch: Any, params: Dict[str, Any], card: str, label: str, **fit: Any
) -> Dict[str, Any]:
    """Phases 6 to 8: one fit of the full batch with its launches, heads
    and the trained model's rating against its reference, then a profile
    of one epoch."""
    run = fit_vaep(batch, params, **fit)
    check_fit(run, params)
    print(
        f"{label} ({batch.total_actions} actions, {run['n_train']} training rows, "
        f"{json.dumps(params)}, card): fit_packed {run['wall_s']:.3f} s, "
        f"launches {json.dumps(run['launches'])} ({card})"
    )
    for col, head in run['heads'].items():
        print(f'{label}: head {col}: {json.dumps(head)}')
    model = run['model']
    check_against_reference(model, batch, model.rate_batch(batch), f'{label}: trained model')
    prof = profile_epoch(model, batch, params)
    print(
        f"profile: one training epoch of one head ({label}, {prof['steps']} steps of "
        f"{params['batch_size']} rows), {prof['wall_ms']:.3f} ms wall under the profiler, "
        f"{prof['kernel_ms']:.3f} ms of kernels in {prof['kernel_calls']} launches "
        f"({prof['launches_per_step']:.1f} a step), device idle {prof['idle_share']:.3f} ({card})"
    )
    for row in prof['top']:
        print(f'  profile: {json.dumps(row)}')
    run['profile'] = prof
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    card = card_identity()
    print(card)
    print(f'precision: {set_precision()}')

    t0 = time.perf_counter()
    cuda_build.load_libraries(KERNELS)
    print(f'build: {len(KERNELS)} libraries in {time.perf_counter() - t0:.2f} s')
    for name in KERNELS:
        print(f"build: {name} {cuda_build.build_seconds[name]:.2f} s")
        for line in cuda_build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
                print(f'  ptxas: {line.strip()}')

    checks = {
        (family, dtype): check_first_layer(device, dtype, family)
        for family in SERVING_SHAPES for dtype in (torch.float32, torch.bfloat16)
    }
    for rec in checks.values():
        print(f'kernel gather_matmul vs plain ({card}): {json.dumps(rec)}')

    # -- phase 4, the VAEP serving path: the entry points' default device
    # (the card), as a user calls them
    serving = serving_phase(make_model(), synthetic_batch(GAMES, ACTIONS, seed=0), card, 'main path')
    torch.cuda.empty_cache()

    # -- the xT path ---------------------------------------------------------
    xt_batch = synthetic_batch(XT_GAMES, ACTIONS, seed=2)
    n_xt = xt_batch.total_actions
    seg_checks = [check_segment_sum(*ops) for ops in segment_operands(xt_batch)]
    torch.cuda.synchronize()

    # the entry points' default device (the card); each fit zeroes the
    # segment-sum count just before it and reads it just after
    card_fits = xt_fits(xt_batch)
    # the same fits again, warm (first-use set-up of the libraries done)
    warm = xt_fits(xt_batch)
    for name, fit in card_fits.items():
        line = {**xt_summary(fit), 'warm_wall_s': warm[name]['wall_s']}
        print(f'xT path ({n_xt} actions, card): {name}: {json.dumps(line)}')
        if fit['launches'] < 1:
            raise RuntimeError(f'{name} did not launch the segment_sum kernel')
    mf = card_fits['ExpectedThreat 192x125']
    if mf['solver'] != 'matrix-free' or mf['launches'] != 3 + int(mf['iterations']):
        raise RuntimeError(
            f"the 192x125 fit launched segment_sum {mf['launches']} times, "
            f"not 3 + {int(mf['iterations'])} iterations"
        )
    seg_launches = sum(fit['launches'] for fit in card_fits.values())
    prof = device_breakdown(lambda: ExpectedThreat(l=192, w=125).fit(xt_batch))
    print(
        f"profile: one ExpectedThreat(192x125).fit, {prof['wall_ms']:.3f} ms wall under "
        f"the profiler, {prof['kernel_ms']:.3f} ms of kernels ({card})"
    )
    for row in prof['top']:
        print(f'  profile: {json.dumps(row)}')

    t0 = time.perf_counter()
    cpu_fits = xt_fits(xt_batch.to('cpu'), 'cpu')
    print(f'xT path (CPU, plain versions): four fits in {time.perf_counter() - t0:.1f} s')
    for name, fit in cpu_fits.items():
        print(f'xT path ({n_xt} actions, CPU): {name}: {json.dumps(xt_summary(fit))}')
    for name, err in compare_fits(card_fits, cpu_fits).items():
        print(f'xT path: card vs CPU: {name}: {json.dumps(err)}')

    del xt_batch, card_fits, warm, cpu_fits
    torch.cuda.empty_cache()

    # -- phase 6, the training path ----------------------------------------------
    train_b1 = check_training_first_layer(device)
    print(f'kernel gather_matmul at the training shape vs plain ({card}): {json.dumps(train_b1)}')
    run = training_phase(synthetic_batch(GAMES, ACTIONS, seed=3), TRAIN_PARAMS, card, 'training path')
    del run['model']
    pbatch = synthetic_batch(PARITY_GAMES, ACTIONS, seed=5)
    parity = parity_fits(pbatch, PARITY_PARAMS, 'training path', PARITY_REPEATS)
    rate_and_fault_fits(pbatch, parity, 'training path')
    del parity, pbatch
    torch.cuda.empty_cache()

    # -- phase 7, Atomic-VAEP ------------------------------------------------------
    abatch = atomic_batch(GAMES, ACTIONS, seed=0)
    atomic_serving = serving_phase(make_model(model_cls=AtomicVAEP), abatch, card, 'atomic path')
    # B2 at the atomic statistics shape: the training rows' state-0 ids
    # into the 128 combined ids, weighted by validity
    stats_rows = AtomicVAEP().training_set(abatch, 0.25, 0).train
    seg_checks.append(check_segment_sum(
        'atomic statistics: training rows into 128 combined ids',
        fused_ops.ATOMIC_REGISTRY.combo_size, stats_rows.weight, stats_rows.combo_ids[:, 0], True,
    ))
    del stats_rows
    atomic_train_b1 = check_training_first_layer(device, 'atomic')
    print(f'kernel gather_matmul at the atomic training shape vs plain ({card}): {json.dumps(atomic_train_b1)}')
    atomic_run = training_phase(abatch, TRAIN_PARAMS, card, 'atomic training path',
                                model_cls=AtomicVAEP)
    del atomic_run['model'], abatch
    parity_fits(atomic_batch(PARITY_GAMES, ACTIONS, seed=5), PARITY_PARAMS, 'atomic training path',
                1, model_cls=AtomicVAEP)
    torch.cuda.empty_cache()

    # -- phase 8, the GRU sequence head ------------------------------------------------
    sbatch = synthetic_batch(GAMES, ACTIONS, seed=3)
    seq_run = training_phase(sbatch, SEQ_PARAMS, card, 'seq training path', learner='seq')
    seq_rate = synced_rate_seconds(seq_run['model'], sbatch)
    print(
        f'seq path: f32 rate_batch {sbatch.total_actions} actions, median {seq_rate * 1e3:.3f} ms, '
        f'{sbatch.total_actions / seq_rate:.1f} actions/s ({card})'
    )
    del seq_run['model'], sbatch
    parity_fits(synthetic_batch(PARITY_GAMES, ACTIONS, seed=5), SEQ_PARITY_PARAMS,
                'seq training path', 1, learner='seq')
    aseq = fit_vaep(atomic_batch(PARITY_GAMES, ACTIONS, seed=6), SEQ_PARITY_PARAMS,
                    model_cls=AtomicVAEP, learner='seq')
    check_fit(aseq, SEQ_PARITY_PARAMS)
    print(
        f"atomic seq path ({PARITY_GAMES} games, card): fit_packed {aseq['wall_s']:.3f} s, "
        f"launches {json.dumps(aseq['launches'])}; heads "
        f"{json.dumps({c: h['epoch_losses'] for c, h in aseq['heads'].items()})}"
    )
    check_against_reference(aseq['model'], aseq['batch'], aseq['model'].rate_batch(aseq['batch']),
                            'atomic seq path: trained model')
    for rec in seg_checks:
        print(f'kernel segment_sum vs plain ({card}): {json.dumps(rec)}')

    b1_paths = {
        'rate_batch': serving['launches']['gather_matmul'],
        'fit_packed': run['launches']['gather_matmul'],
        'atomic rate_batch': atomic_serving['launches']['gather_matmul'],
        'atomic fit_packed': atomic_run['launches']['gather_matmul'],
        'seq fit_packed': seq_run['launches']['gather_matmul'],
    }
    b2_paths = {
        'xT fits': seg_launches,
        'fit_packed': run['launches']['segment_sum'],
        'atomic fit_packed': atomic_run['launches']['segment_sum'],
        'seq fit_packed': seq_run['launches']['segment_sum'],
        'atomic seq fit_packed': aseq['launches']['segment_sum'],
    }
    f32 = checks[('standard', torch.float32)]
    sweep = seg_checks[1]
    kernels = [{
        'name': 'gather_matmul',
        'route': 'cuda',
        'source': 'socceraction_tpu_torch/csrc/gather_matmul.cu',
        'replaces': 'socceraction_tpu/ops/gather_matmul.py:117',
        'launches': sum(b1_paths.values()),
        'launches_by_path': b1_paths,
        'max_abs_err': max(
            max(rec['max_abs_err'] for rec in checks.values()), train_b1['max_abs_err'],
            atomic_train_b1['max_abs_err'],
        ),
        'ms': f32['ms'],
        'plain_ms': f32['plain_ms'],
        'bound_ms': f32['bound_ms'],
        'bound_by': f32['bound_by'],
        # no single PyTorch call computes bias + k masked gathers + x @ W
        'library_ms': None,
        'serving_shapes': [
            {k: rec[k] for k in (
                'family', 'shape', 'dtype', 'plan', 'max_abs_err', 'ms', 'plain_ms',
                'bound_ms', 'bound_by', 'bytes_bound_ms', 'ops_bound_ms', 'gather_bytes',
            )}
            for rec in checks.values()
        ],
        'main_path_operands': {
            label: {**{k: rec['main_b1'][k] for k in ('shape', 'distinct_ids', 'ms', 'bound_ms')},
                    'plans': rec['launches']['gather_matmul_plans']}
            for label, rec in (('standard', serving), ('atomic', atomic_serving))
        },
        'training_shapes': [
            {k: rec[k] for k in (
                'shape', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'backward_ms',
                'backward_step_ms',
            )}
            for rec in (train_b1, atomic_train_b1)
        ],
        'ptxas': cuda_build.ptxas_report('gather_matmul'),
    }, {
        'name': 'segment_sum',
        'route': 'cuda',
        'source': 'socceraction_tpu_torch/csrc/segment_sum.cu',
        'replaces': 'socceraction_tpu/ops/segment.py:94',
        'launches': sum(b2_paths.values()),
        'launches_by_path': b2_paths,
        'max_abs_err': max(rec['max_abs_err'] for rec in seg_checks),
        # the 192 x 125 payoff shape, the one every matrix-free sweep runs
        'ms': sweep['ms'],
        'plain_ms': sweep['plain_ms'],
        'bound_ms': sweep['bound_ms'],
        'bound_by': sweep['bound_by'],
        'library_ms': sweep['library_ms'],
        'shapes': [
            {k: rec[k] for k in (
                'shape', 'segments', 'max_abs_err', 'ms', 'event_ms', 'plain_ms', 'library_ms',
                'bound_ms', 'plan',
            )}
            for rec in seg_checks
        ],
        'ptxas': cuda_build.ptxas_report('segment_sum'),
    }]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({
        'ok': True,
        'device': {
            'platform': 'gpu',
            'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
