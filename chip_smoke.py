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
   repeat held to the CPU's within 1e-4; and a profile of one training
   epoch.

Before the last line it prints one JSON object of kernel records
(``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from socceraction_tpu_torch.convert import mlp_from_jax_params
from socceraction_tpu_torch.core.batch import ActionBatch
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.device import DeviceLike
from socceraction_tpu_torch.ml import mlp as mlp_mod
from socceraction_tpu_torch.ops import cuda_build
from socceraction_tpu_torch.ops import fused as fused_ops
from socceraction_tpu_torch.ops import gather_matmul as gm
from socceraction_tpu_torch.ops import segment as seg
from socceraction_tpu_torch.ops import xt as xtops
from socceraction_tpu_torch.ops.features import compute_features
from socceraction_tpu_torch.ops.fused import train_layout
from socceraction_tpu_torch.vaep.base import VAEP, XFNS_DEFAULT, split_rows
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
#: minibatch wraps) at the JAX package's training-parity rate.
PARITY_GAMES = 64
PARITY_PARAMS = {**TRAIN_PARAMS, 'max_epochs': 2, 'learning_rate': 3e-4}
#: Further card fits of the parity batch, each compared with the first.
PARITY_REPEATS = 4


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


def check_first_layer(device: torch.device, dtype: torch.dtype) -> Dict[str, Any]:
    """B1 against its plain version at the serving shape (phase 3)."""
    n = GAMES * ACTIONS
    ops = first_layer_operands(device, dtype, n)
    got = gm.fused_first_layer_quant(*ops)
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


def make_model(device: DeviceLike = None, hidden: Tuple[int, ...] = HIDDEN) -> VAEP:
    """A VAEP with two seeded random MLP heads, carried through the converter.

    Standardization statistics are numpy means/stds of the features of a
    small seeded batch. Two choices keep the heads like trained ones, so
    the quantized bands are measured where served values live: output
    biases sit at logit(0.01) (a goal within ten actions is a rare event),
    and the ``Dense_0`` row of a one-hot column is scaled by ``min(1, 2σ)``
    (a rarely active column gets few updates, so its weight on the raw
    0/1 input stays small instead of growing as ``1/σ``).
    """
    sample = compute_features(
        synthetic_batch(8, ACTIONS, seed=1, device=device), names=XFNS_DEFAULT, k=K
    )
    X = sample.reshape(-1, sample.shape[-1]).cpu().numpy()
    mean = X.mean(axis=0)
    std = X.std(axis=0)
    std = np.where(std > 0, std, 1.0).astype(np.float32)
    n_features = X.shape[1]
    layout = train_layout(XFNS_DEFAULT, K)
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
    return VAEP(models=heads, device=device)


def rate_main_path(model: VAEP, batch: Any) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Drive ``rate_batch`` once with every launch count zeroed just before
    and read just after (phase 4)."""
    gm.fused_first_layer_quant.launches = 0
    values = model.rate_batch(batch)
    torch.cuda.synchronize()
    return values, {'gather_matmul': gm.fused_first_layer_quant.launches}


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


def check_training_first_layer(device: torch.device) -> Dict[str, Any]:
    """B1 at the training shape (one minibatch of 8192 rows, one 128-wide
    head) against its plain version, and the backward's parts, each timed
    as a replayed graph (phase 6)."""
    n, h, r = TRAIN_PARAMS['batch_size'], HIDDEN[0], 552
    ops = first_layer_operands(device, torch.float32, n, seed=4, h=h)
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


def fit_vaep(batch: ActionBatch, params: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """``VAEP(device).fit_packed(batch, tree_params=params, random_state=0)``
    with both kernels' counts zeroed just before and read just after,
    synchronized, with its wall time and a record per head (phase 6)."""
    dev = batch.device
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    model = VAEP(device=device).fit_packed(batch, tree_params=params, random_state=0)
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
    return {'model': model, 'batch': batch, 'wall_s': wall, 'launches': launches,
            'n_train': n_train, 'steps_per_epoch': steps, 'heads': heads}


def check_fit(run: Dict[str, Any], params: Dict[str, Any]) -> None:
    """Raise unless every head trained with finite health and a loss that
    fell from the first epoch to the last, and, on the card, B1 launched on
    every step and B2 for the statistics."""
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
    if run['launches']['gather_matmul'] < steps:
        raise RuntimeError(
            f"fit_packed launched gather_matmul {run['launches']['gather_matmul']} times "
            f'for {steps} training steps'
        )
    # k histograms into the combined ids, then k per one-hot block
    if run['launches']['segment_sum'] < 15:
        raise RuntimeError(f"the statistics pass launched segment_sum {run['launches']['segment_sum']} times, not 15")


def head_trainer(model: VAEP, data: Any, params: Dict[str, Any]) -> Tuple[Any, Dict[str, torch.Tensor], Any]:
    """A fresh scores head's epoch trainer, the rows it trains on and its
    module, with the fitted model's statistics: a classifier of the same
    seed starts from the same weights and draws the same permutations."""
    clf = mlp_mod.MLPClassifier(**params, device=model.device)
    head = model._models['scores']
    module, rows, loss_fn, _, _, _ = clf._packed_problem(
        (data.train, data.layout), data.y_train['scores'], names=model.xfns,
        k=model.nb_prev_actions, mean=head.mean_, std=head.std_,
    )
    module.requires_grad_(True)
    trainer = mlp_mod._EpochTrainer(
        loss_fn, list(module.parameters()), int(data.train.weight.shape[0]),
        clf.batch_size, clf.seed, clf.learning_rate,
    )
    return trainer, rows, module


def first_step_gradients(model: VAEP, data: Any, params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The gradient of the scores head's first training step."""
    trainer, rows, module = head_trainer(model, data, params)
    idx = trainer._permutation(0)[trainer.slot_pos[: trainer.batch_size]]
    loss = trainer.loss_fn({name: t.index_select(0, idx) for name, t in rows.items()},
                           trainer.slot_weight[0])
    grads = torch.autograd.grad(loss, trainer.params)
    return {name: _np(g) for (name, _), g in zip(module.named_parameters(), grads)}


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
    JAX package's own training-parity bound.
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
        # where in the first layer: the feature column, its kind and its
        # mean (a one-hot column's activation frequency)
        w_gap = (ha.module.Dense_0.weight - hb.module.Dense_0.weight.to(ha.device)).abs()
        unit, column = divmod(int(w_gap.argmax()), w_gap.shape[1])
        kind = next(kd for _, kd, off, width in da.layout.spans if off <= column < off + width)
        report[col] = {
            'std_rel': std_rel, 'mean_rel': mean_rel, 'param_gap': gaps[worst],
            'param_gap_at': worst, 'param_gaps': gaps,
            'dense_0_gap_at': {'unit': unit, 'column': column, 'kind': kind,
                               'column_mean': float(mean_b[column])},
        }
        if not gaps[worst] <= 1e-4:
            raise RuntimeError(f'{col}: card and CPU parameters differ by {gaps[worst]} at {worst}: {gaps}')
    ga, gb = first_step_gradients(a, da, params), first_step_gradients(b, db, params)
    grad_rel = {
        name: float(np.abs(ga[name] - gb[name]).max() / max(np.abs(gb[name]).max(), 1e-30))
        for name in ga
    }
    report['first_step_grad_rel'] = grad_rel
    if not max(grad_rel.values()) <= 1e-5:
        raise RuntimeError(f'first-step gradients differ: {grad_rel}')
    return report


def profile_epoch(model: VAEP, batch: ActionBatch, params: Dict[str, Any]) -> Dict[str, Any]:
    """``torch.profiler`` over one training epoch of a fresh scores head on
    the batch's training rows (no eval), after one warm-up epoch."""
    trainer, rows, _ = head_trainer(model, model.training_set(batch, 0.25, 0), params)
    state = mlp_mod.AdamState.zeros(trainer.params)
    state, _, _ = trainer.run(state, 0, rows)
    prof = device_breakdown(lambda: trainer.run(state, 1, rows), top=12)
    prof['steps'] = trainer.steps
    prof['idle_share'] = 1.0 - prof['kernel_ms'] / prof['wall_ms']
    return prof

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

    checks = {dtype: check_first_layer(device, dtype) for dtype in (torch.float32, torch.bfloat16)}
    for rec in checks.values():
        print(f'kernel gather_matmul vs plain ({card}): {json.dumps(rec)}')

    # the entry points' default device (the card), as a user calls them
    model = make_model()
    batch = synthetic_batch(GAMES, ACTIONS, seed=0)
    values, launches = rate_main_path(model, batch)
    print(f'main path: rate_batch {tuple(values.shape)}, launches {launches}')
    if launches['gather_matmul'] < 1:
        raise RuntimeError('rate_batch did not launch the gather_matmul kernel')
    if tuple(values.shape) != (GAMES, ACTIONS, 3) or not bool(torch.isfinite(values).all()):
        raise RuntimeError('rate_batch values are not finite values of shape (512, 1664, 3)')
    ref = model.rate_batch_reference(batch)
    err = float((values - ref).abs().max())
    print(f'main path: max |rate_batch - rate_batch_reference| = {err:.3e} (limit 1e-5)')
    if not err <= 1e-5:
        raise RuntimeError(f'rate_batch disagrees with the materialized reference: {err}')
    del ref
    for mode in ('bf16', 'int8'):
        model.set_quantize(mode)
        q = model.rate_batch(batch)
        q_err = float((q - values).abs().max())
        print(f'main path: max |{mode} - f32| = {q_err:.3e} (limit 1e-3)')
        if not (bool(torch.isfinite(q).all()) and q_err <= 1e-3):
            raise RuntimeError(f'{mode} serving is outside the 1e-3 band: {q_err}')
    model.set_quantize('none')
    main_b1 = main_path_first_layer(model, batch)  # also rebuilds the f32 fold
    print(f'kernel gather_matmul on the main path\'s operands ({card}): {json.dumps(main_b1)}')
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.rate_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n_actions = batch.total_actions
    print(
        f'main path: f32 rate_batch {n_actions} actions, median '
        f'{np.median(times) * 1e3:.3f} ms, {n_actions / np.median(times):.1f} actions/s '
        f'({card}); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB'
    )
    prof = device_breakdown(lambda: model.rate_batch(batch))
    print(
        f"profile: one f32 rate_batch, {prof['wall_ms']:.3f} ms wall under the "
        f"profiler, {prof['kernel_ms']:.3f} ms of kernels ({card})"
    )
    for row in prof['top']:
        print(f'  profile: {json.dumps(row)}')

    del model, batch, values
    torch.cuda.empty_cache()

    # -- the xT path ---------------------------------------------------------
    xt_batch = synthetic_batch(XT_GAMES, ACTIONS, seed=2)
    n_xt = xt_batch.total_actions
    seg_checks = [check_segment_sum(*ops) for ops in segment_operands(xt_batch)]
    for rec in seg_checks:
        print(f'kernel segment_sum vs plain ({card}): {json.dumps(rec)}')
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

    # -- the training path -----------------------------------------------------
    train_b1 = check_training_first_layer(device)
    print(f'kernel gather_matmul at the training shape vs plain ({card}): {json.dumps(train_b1)}')
    batch = synthetic_batch(GAMES, ACTIONS, seed=3)
    run = fit_vaep(batch, TRAIN_PARAMS)
    check_fit(run, TRAIN_PARAMS)
    print(
        f"training path ({batch.total_actions} actions, {run['n_train']} training rows, "
        f"{json.dumps(TRAIN_PARAMS)}, card): fit_packed {run['wall_s']:.3f} s, "
        f"launches {json.dumps(run['launches'])} ({card})"
    )
    for col, head in run['heads'].items():
        print(f'training path: head {col}: {json.dumps(head)}')
    model = run['model']
    values = model.rate_batch(batch)
    ref = model.rate_batch_reference(batch)
    err = float((values - ref).abs().max())
    print(f'training path: trained model, max |rate_batch - rate_batch_reference| = {err:.3e} (limit 1e-5)')
    if not (bool(torch.isfinite(values).all()) and err <= 1e-5):
        raise RuntimeError(f'the trained model rates {err} from its reference')
    del values, ref
    prof = profile_epoch(model, batch, TRAIN_PARAMS)
    print(
        f"profile: one training epoch of one head ({prof['steps']} steps of "
        f"{TRAIN_PARAMS['batch_size']} rows), {prof['wall_ms']:.3f} ms wall under the profiler, "
        f"{prof['kernel_ms']:.3f} ms of kernels in {prof['kernel_calls']} launches, device idle "
        f"{prof['idle_share']:.3f} ({card})"
    )
    for row in prof['top']:
        print(f'  profile: {json.dumps(row)}')
    del model, batch, run['model']
    torch.cuda.empty_cache()

    pbatch = synthetic_batch(PARITY_GAMES, ACTIONS, seed=5)
    card_run = fit_vaep(pbatch, PARITY_PARAMS)
    check_fit(card_run, PARITY_PARAMS)
    t0 = time.perf_counter()
    cpu_run = fit_vaep(pbatch.to('cpu'), PARITY_PARAMS, 'cpu')
    print(f'training path (CPU, plain versions): fit_packed in {time.perf_counter() - t0:.1f} s')
    check_fit(cpu_run, PARITY_PARAMS)
    parity = compare_training(card_run, cpu_run, PARITY_PARAMS)
    print(
        f"training path: card vs CPU ({PARITY_GAMES} games, {card_run['n_train']} training rows, "
        f"{json.dumps(PARITY_PARAMS)}): {json.dumps(parity)}"
    )
    # the card's fit is reproducible (no atomics in the training step):
    # the same fit is repeated, and every repeat held to the CPU's too
    gaps = {col: {'card_vs_cpu': [parity[col]['param_gap']], 'card_vs_card': []}
            for col in card_run['model']._models}
    for _ in range(PARITY_REPEATS):
        repeat = fit_vaep(pbatch, PARITY_PARAMS)['model']
        for col, g in gaps.items():
            g['card_vs_cpu'].append(max_param_gap(repeat, cpu_run['model'], col))
            g['card_vs_card'].append(max_param_gap(repeat, card_run['model'], col))
            if not g['card_vs_cpu'][-1] <= 1e-4:
                raise RuntimeError(f"{col}: a repeated card fit is {g['card_vs_cpu'][-1]} from the CPU's")
        del repeat
    print(
        f'training path: the card fit {1 + PARITY_REPEATS} times, max parameter gap per fit '
        f'(the first fit is card_vs_card\'s reference): {json.dumps(gaps)}'
    )

    f32 = checks[torch.float32]
    sweep = seg_checks[1]
    kernels = [{
        'name': 'gather_matmul',
        'route': 'cuda',
        'source': 'socceraction_tpu_torch/csrc/gather_matmul.cu',
        'replaces': 'socceraction_tpu/ops/gather_matmul.py:117',
        'launches': launches['gather_matmul'] + run['launches']['gather_matmul'],
        'launches_by_path': {
            'rate_batch': launches['gather_matmul'],
            'fit_packed': run['launches']['gather_matmul'],
        },
        'max_abs_err': max(
            max(rec['max_abs_err'] for rec in checks.values()), train_b1['max_abs_err']
        ),
        'ms': f32['ms'],
        'plain_ms': f32['plain_ms'],
        'bound_ms': f32['bound_ms'],
        'bound_by': f32['bound_by'],
        # no single PyTorch call computes bias + k masked gathers + x @ W
        'library_ms': None,
        'dtypes': [
            {k: rec[k] for k in (
                'dtype', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bytes_bound_ms',
                'ops_bound_ms', 'gather_bytes',
            )}
            for rec in checks.values()
        ],
        'main_path_operands': {k: main_b1[k] for k in ('shape', 'distinct_ids', 'ms', 'bound_ms')},
        'training_shape': {k: train_b1[k] for k in (
            'shape', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'backward_ms',
            'backward_step_ms',
        )},
        'ptxas': cuda_build.ptxas_report('gather_matmul'),
    }, {
        'name': 'segment_sum',
        'route': 'cuda',
        'source': 'socceraction_tpu_torch/csrc/segment_sum.cu',
        'replaces': 'socceraction_tpu/ops/segment.py:94',
        'launches': seg_launches + run['launches']['segment_sum'],
        'launches_by_path': {'xT fits': seg_launches, 'fit_packed': run['launches']['segment_sum']},
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
