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

9. the season feed: phase 5's draw (3072 x 1664, host copy) written into a
   packed-season cache through ``PackedSeasonWriter`` over a stand-in
   store (the card's machine reads no parquet or HDF5), streamed by
   ``iter_batches`` in 6 chunks of 512 games two chunks ahead and
   synchronously, every chunk held bitwise to the batch built directly
   from the same arrays and rated through B1 (values within 1e-6 of the
   direct batches'); three timed epochs at each depth beside the consumer
   alone, the stage medians, one chunk's wire copied alone from pinned
   memory, a profile's idle share; the whole season taken at once and
   fitted (16 x 12), held to phase 5's fit (equal sweeps, grid 1e-6); a
   ragged 512-game Atomic-SPADL cache taken whole, held bitwise and rated;
10. counterfactuals: ``rate_scenarios_batch`` over a 12 x 8 end-location
   grid (96 perturbations) and 4 games, one launch of B1, against the
   loop of 96 ``rate_batch`` calls and the reference on the first 4
   perturbations (1e-5), with both values/s;
11. telemetry: ``rate_batch`` at phase 4's shape with the numeric guards
   on: nothing drained for the model, and for copies with a NaN planted
   in a first-layer weight and with the output layer scaled past 88, the
   drained counts equal those of the same planted model rated on the CPU;
   guarded values bitwise the unguarded; the host reads and stream waits
   of one call equal with telemetry on and off (``torch.profiler``), the
   guard's cost in synced walls; ``record_dispatch`` over 20 synced calls
   (``roofline_frac`` in (0, 1.05]); the memory gauges and the residency
   report with an ``xt_fleet`` and a ``pipeline_feed`` claim held;
   ``ParityProbe`` on its own stream (f32 ≤ 1e-5, bf16 ≤ 1e-3, a planted
   1e-3 offset caught); a run log and a debug bundle with the card's
   memory; the dispatch observatory, the ``nvcc`` builds and the
   cold-start report of this process;
12. the rating dispatch and the gate's statistics: ``rate_batch`` forced
   onto ``fused``, ``fused_bf16`` and ``materialized`` for both families
   (B1 1, 1 and 0 launches; f32 paths within 1e-5 of the reference,
   bf16 within 0.05 of f32; no host read; synced medians as actions/s; the
   measured winner against the committed ``cuda`` profile entry), a
   mixed MLP/seq pair (1e-5), both ``predict_proba_device_batch`` entries,
   ``shadow_replay`` with 200 resamples and a drift watch on the batch and
   on a copy shifted in ``start_x``, held to the port's statistics on the
   CPU over the card's probabilities (1e-6), and B1 and B2 against their
   plain versions at this phase's shapes;
13. the continuous-learning loop (``ContinuousLearner`` with no rating
   service) over a seeded league season of 380 games x 1664 actions, 370
   stored first, through a stand-in store whose landed games move its
   fingerprint and a packed cache the phase brings up to date itself
   (``PackedSeasonWriter.seed_from`` plus the new games): a bootstrap
   iteration promoted as version 1; the last round of 10 games lands and
   a warm-started iteration runs ((128, 128) heads, minibatches of 8192, 3
   epochs, lr 3e-4, the fed fit launching B1 and B2); a degraded candidate
   (fresh init, 0 epochs) rejected and left staged; ``rollback`` to
   version 1. Each iteration's verdict, journal stages (the JAX package's
   grammar), ``learn/stage_seconds``, wall and launches; its shadow
   statistics (200 resamples over the 16 newest games not just landed)
   held to the port's on the CPU over the card's probabilities (1e-6);
   each promoted version read back from disk by a fresh ``ModelRegistry``
   (no ``msgpack``), its claimed bytes beside the allocator's delta,
   rating the phase-4 batch bitwise as its in-memory candidate; B1 at the
   loop's training shape against its plain version;
14. the scale-out layer: (a) one NCCL rank in this process against the
   single-device paths, (b) two gloo ranks spawned on the same card
   (``--scale-rank``) against (a), with B1 and B2's launches per path;
15. the cross-process telemetry plane: phase 4's model published in a
   ``ModelRegistry``, four replica processes spawned on the same card
   (``--fleet-replica``), each activating it with the built kernels behind
   its own ``RatingService`` (phase 16's shape, an SLO and a parity probe
   on every flush), timing a bare ``rate_batch`` of its own seeded 512 x
   1664 batch (replica 0 phase 4's, bitwise) while the others rate, then
   serving 8 one-game requests of that batch through the service and the
   service's telemetry on a unix socket; replica 0's service serves one
   request under a context this process minted, both writing run logs. A
   ``FleetAggregator`` here scrapes all four: the merged requests, rated
   actions, ``rate_batch`` calls and SLO events equal the replicas' own
   counts exactly, with the services' divergence rows per replica; after a
   SIGKILL of the last replica, exactly it is stale, the status degraded
   and the sums unchanged; the two run logs hold one request id one hop
   apart, through the service's own flush;
16. in-process serving: a ``RatingService`` over phase 4's model at the
   JAX service's default shape (window 1664, ladder 1 to 64, 2 ms wait,
   queue 256), each request a one-game host staging batch built from
   seeded arrays and submitted where ``rate`` arrives once it has packed
   its frame (the card's machine has no pandas): (a) ``warmup()``, one B1
   launch a rung; (b) 16 client threads x 32 requests of 1200 to 1664
   actions, each within 1e-5 of its own one-game ``rate_batch_reference``
   and ``rate_batch``, with requests/s, actions/s, the request-seconds
   quantiles, flushes by reason, fill and buckets, B1 launches equal to
   the fused flushes, no fallback flush and no new shape; one flush under
   ``torch.profiler`` with no host read before its values' copy, and flush
   walls against a bare ``rate_batch`` at the same bucket; (c) two
   versions in a ``ModelRegistry`` under ``build/serve``, swapped while 4
   clients submit 16 requests each (every request wholly one version's,
   every request after the swap v2's) and rolled back; (d) a breaker drill
   on an injected clock (``serve.dispatch`` faults on calls 1 and 2: two
   flushes through the reference, one skipped while open, one half-open
   probe through B1 that closes it); (e) B1's library load made to fail
   as ``dlopen`` would (an ``OSError``), which B1's wrapper raises as a
   ``KernelError``: the request fails, the breaker and the fallback count
   do not move, and the next request is served through B1; (f)
   ``close(drain=True)`` resolves the queue and refuses what comes after;
   (g) to (k) the scenario verb, the parity probe on every flush, SLO
   admission, the scenario breaker and ``telemetry()`` scraped;
17. serving's outer tier: (a) the same service behind four replica lanes
   on the one card (``RatingService(n_replicas=4)``: a stream each, the
   model's weights shared, no allocation to build it), every lane warmed,
   phase 16's traffic through one lane and through the lanes (B1 launches
   equal to the flushes, every lane flushing, no fallback, no new shape,
   each request within 1e-5 of its reference and of the one-lane value),
   one-request flushes bitwise the one-lane service's on every lane, a
   flush alone on a lane timed against one lane's, a sick lane named by
   ``health()``, B1 that cannot load on one lane's stream (``KernelError``,
   nothing degraded), a swap that fails on lane 1's warm-up and then lands
   on every lane; (b) the warm tier: a version published with its two
   kernel libraries, started in two child processes from empty compile
   caches (``--aot-replica``): one installs the shipped libraries and runs
   no ``nvcc``, one whose manifest names another card and toolkit reads
   ``stale`` and builds; both rate a request bitwise as this process, and
   print their cold-start timelines; (c) ``GET /health`` through a
   ``ServingFrontend`` on a unix socket equal to ``health()``;
18. the device work under the DataFrame layer (the card's machine has no
   pandas, so it enters where ``VAEP.fit`` and ``compute_features`` hand
   arrays on): (a) the 512 x 1664 batch's feature and label rows computed
   on the card and unpacked as ``compute_features``/``compute_labels``
   fill their frames, then ``VAEP.fit_rows`` (``fit`` after its column
   selection: the split and one ``LEARNERS['mlp']`` call per label) with
   (128, 128) heads, batches of 8192 and 3 epochs on the card, its wall
   beside phase 6's ``fit_packed`` and the bytes each way; (b) the fitted
   model's ``rate_batch``: the fused path, B1 once, within 1e-5 of its
   reference, B1 against its plain version on the operands it was handed;
   (c) the same remainder on 64 games on the card and on the CPU (lr 1e-4,
   2 epochs): the split equal, statistics within 1e-6, every parameter
   within 1e-4; (d) the pandas backend's numpy value iteration over phase
   5's 16 x 12 card fit's matrices: its grid within 1e-5, its sweeps within
   one.
19. the synthetic quality tier (the JAX package's
   ``tests/test_quality_synthetic.py`` on the card): (a) 48 games of 1000
   actions drawn with the chain generator's pandas-free core, timed on the
   host, their columns' sha256 equal to :data:`SEASON_DIGEST` (the JAX
   package's frames hash to it); (b) k = 3 feature and label rows of the 36
   training games on the card and ``fit_rows(learner='mlp')`` with (128,
   128) heads, batch 2048, up to 100 epochs, patience 10; (c) both heads'
   probabilities of the 12 held-out games through B1
   (``predict_proba_device_batch``), AUROC above 0.78 and Brier below 0.06
   on both, a shuffled-label control's AUROC below 0.58, and B1 against its
   plain version on the held-out operands.
20. the Wyscout and Opta loaders (the card's machine has neither pandas
   nor lxml): (a) the ``data.wyscout`` and ``data.opta`` packages and every
   parser module imported, the deprecated ``spadl.opta.OptaLoader``,
   ``spadl.wyscout.WyscoutLoader`` and ``PublicWyscoutLoader`` resolved to
   the port's classes with a ``DeprecationWarning``, and neither pandas nor
   lxml loaded; (b) the F1, F9, F24 and MA1 JSON parsers, MA3 (less
   ``extract_players``) and WhoScored over the repo's fixture feeds, every
   pandas-free ``extract_*`` method, each parser's records hashed and held
   to :data:`PROVIDER_DIGESTS` (the JAX package's parsers hash to them);
   (c) the six fixture layouts' games (Opta XML and JSON, StatsPerform,
   WhoScored, the Wyscout public release and API; loader, then
   ``convert_to_actions``, read from :data:`PROVIDER_SPADL`) packed into
   one batch and rated by phase 4's model: B1 once, within 1e-5 of
   ``rate_batch_reference`` and of the same model's values on the CPU, B1
   against its plain version on the operands it was handed.
21. seq and mixed heads behind the rating service, at phase 16's shape: a
   seq pair (two GRU heads at 32/64/64) warms every (bucket, window rung)
   shape; each window band's requests (lengths in (previous rung, rung])
   land on its rung; phase 16's 512 requests go through a mixed MLP/seq
   pair, whose materialized path reaches no B1; every request within 1e-5
   of its reference; a swap from phase 4's model to the seq pair with
   every shape warmed before it serves, and back; B1 unloadable under
   mixed-pair flushes changes nothing (see :func:`seq_serve_phase`).

Phase 3 also holds B1 at the atomic serving shape (R = 128, D = 46) and B2
at the atomic statistics shape to their plain versions.

Before the last line it prints one JSON object of kernel records
(``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import functools
import gc
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from socceraction_tpu_torch.atomic.spadl import config as atomicconfig
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.convert import mlp_from_jax_params
from socceraction_tpu_torch.core.batch import (
    ActionBatch,
    AtomicActionBatch,
    _from_numpy,
    bucket_window,
    pad_length,
    window_ladder,
)
from socceraction_tpu_torch.core.synthetic import (
    CHAIN_COLUMNS,
    _chain_columns,
    _draw_spadl_columns,
    synthetic_batch,
)
from socceraction_tpu_torch.device import DeviceLike, resolve_device
from socceraction_tpu_torch.ml import mlp as mlp_mod
from socceraction_tpu_torch.ops import cuda_build
from socceraction_tpu_torch.ops import fused as fused_ops
from socceraction_tpu_torch.ops import gather_matmul as gm
from socceraction_tpu_torch.ops import segment as seg
from socceraction_tpu_torch.ops import xt as xtops
from socceraction_tpu_torch.obs import (
    NAME_RE,
    REGISTRY,
    ParityProbe,
    RunLog,
    claim_bytes,
    coldstart_report,
    dump_debug_bundle,
    fn_cost,
    live_array_census,
    numerics,
    observatory_snapshot,
    perf_snapshot,
    record_dispatch,
    residency_report,
    sample_device_memory,
    span,
)
from socceraction_tpu_torch.obs.coldstart import TIMELINE
from socceraction_tpu_torch.obs.context import (
    RequestContext,
    new_request_context,
    record_request_done,
    record_request_enqueue,
)
from socceraction_tpu_torch.obs.endpoint import (
    EndpointError,
    fetch,
    scrape_health,
    serve_telemetry,
)
from socceraction_tpu_torch.obs.fleet import FleetAggregator
from socceraction_tpu_torch.obs.metrics import MetricRegistry
from socceraction_tpu_torch.obs.slo import SLOConfig
from socceraction_tpu_torch.obs.perf import DEVICE_PEAKS
from socceraction_tpu_torch.ops.fused import train_layout
from socceraction_tpu_torch.pipeline.feed import iter_batches
from socceraction_tpu_torch.pipeline.packed import (
    PackedSeason,
    PackedSeasonWriter,
    open_packed,
    ship_host_batch,
)
from socceraction_tpu_torch.scenario import (
    ScenarioGrid,
    action_type_sweep,
    bucket_perturbations,
    custom_grid,
    decision_surface,
    end_location_grid,
    expand_scenarios,
    pad_perturbations,
    rate_scenarios_batch,
    rate_scenarios_looped,
    rate_scenarios_reference,
)
from socceraction_tpu_torch.learn import calibration as learn_calibration
from socceraction_tpu_torch.learn import drift as learn_drift
from socceraction_tpu_torch.learn import loop as loop_mod
from socceraction_tpu_torch.learn import (
    ContinuousLearner,
    DriftConfig,
    DriftWatch,
    GateConfig,
    LearnConfig,
    calibration_summary,
    newest_game_ids,
    replay_probs,
    shadow_replay,
)
from socceraction_tpu_torch.ops.profile import preferred_rating_path
from socceraction_tpu_torch.seq.classifier import SeqClassifier
from socceraction_tpu_torch.resil import CircuitBreaker, FaultPlan, FaultSpec
from socceraction_tpu_torch.config import COMPILE_CACHE_ENV, compile_cache_dir
from socceraction_tpu_torch.serve import ModelRegistry, RatingService, SLOShed
from socceraction_tpu_torch.serve import service as serve_service
# the kernels this script builds: the libraries a version ships
from socceraction_tpu_torch.serve.aot import KERNELS, env_fingerprint, read_manifest
from socceraction_tpu_torch.serve.frontend import FrontendClient, ServingFrontend
from socceraction_tpu_torch.serve.session import goalscore_block, score_prefix
from socceraction_tpu_torch.vaep.base import VAEP, load_model, split_rows
from socceraction_tpu_torch.xthreat import ExpectedThreat
from socceraction_tpu_torch import parallel as scale
from socceraction_tpu_torch.parallel import vaep as scale_vaep

#: The serving batch: 512 games of 1664 actions (851,968 rows).
GAMES, ACTIONS = 512, 1664
#: The repo's default MLP head widths.
HIDDEN = (128, 128)
K = 3
#: Published H100 SXM peaks at a 700 W power limit (the port's one table,
#: ``obs/perf.py:DEVICE_PEAKS``): HBM bytes/s, f32 FLOP/s outside the
#: tensor cores and dense TF32 FLOP/s on them.
_H100 = DEVICE_PEAKS['NVIDIA H100 80GB HBM3']
PEAK_BYTES_PER_S = _H100['bytes_per_s']
PEAK_F32_FLOPS = _H100['flops_f32']
PEAK_TF32_FLOPS = _H100['flops_tf32']
#: The xT batch: 3072 games of 1664 actions (5,111,808 actions).
XT_GAMES = 3072
#: Groups of the xT fleet fits (``game_index % XT_GROUPS``).
XT_GROUPS = 20
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
#: The season feed (phase 9): the xT draw streamed from its packed cache in
#: chunks of 512 games, two chunks ahead.
FEED_GAMES = 512
FEED_PREFETCH = 2
#: Where phase 9 writes its caches (git-ignored, removed at the end).
FEED_DIR = os.path.join('build', 'feed')
#: Counterfactuals (phase 10): a 12 x 8 end-location grid (96
#: perturbations) over 4 games, folded to 384 games (bucketed to 512).
SCENARIO_GAMES = 4
SCENARIO_GRID = (12, 8)


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

    The bytes and operations are ``gather_matmul.first_layer_cost``'s, with
    this input's valid ids: every input read once, the output written once;
    the dense product as the kernel computes it, 3xTF32 on the tensor cores,
    at the TF32 rate, plus one f32 add per valid gathered element at the f32
    rate. Beside it, the bytes the gathers move from L2
    (one table row element per valid id and column), which no design
    avoids while the tables do not fit on chip.
    """
    tables, w, bias, ids, x = operands
    k, r, h = tables.shape
    n, d = x.shape
    valid = int(((ids >= 0) & (ids < r)).sum())
    cost = gm.first_layer_cost(n, k, r, h, d, table_dtype=tables.dtype, valid=valid)
    t_bytes = cost['bytes'] / PEAK_BYTES_PER_S * 1e3
    t_ops = (cost['tf32_flops'] / PEAK_TF32_FLOPS + cost['f32_flops'] / PEAK_F32_FLOPS) * 1e3
    return {
        'bound_ms': max(t_bytes, t_ops),
        'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
        'bytes_bound_ms': t_bytes,
        'ops_bound_ms': t_ops,
        'gather_bytes': valid * h * tables.element_size(),
    }


def check_first_layer(
    device: torch.device, dtype: torch.dtype, family: str = 'standard',
    ops: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Dict[str, Any]:
    """B1 against its plain version at a family's serving shape (phase 3),
    or on the operands ``ops`` (phase 18: those a ``rate_batch`` hands B1)."""
    if ops is None:
        r, d = SERVING_SHAPES[family]
        ops = first_layer_operands(device, dtype, GAMES * ACTIONS, r=r, d=d)
    tables, _, _, ids, x = ops
    (n, k), (r, h), d = ids.shape, tables.shape[1:], x.shape[1]
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
        'shape': {'n': n, 'k': k, 'r': r, 'h': h, 'd': d},
        'plan': plan,
        'dtype': str(tables.dtype).replace('torch.', ''),
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


@contextlib.contextmanager
def captured(module: Any, name: str, first_only: bool = False) -> Any:
    """Record ``(args, kwargs, result)`` of the calls of ``module.name`` in
    the enclosed block (the list it yields; ``first_only``: the first
    call's only), the calls going through."""
    fn = getattr(module, name)
    calls: List[Tuple[Any, ...]] = []

    @functools.wraps(fn)  # and its attributes: a wrapper counts its launches on itself
    def capture(*args: Any, **kwargs: Any) -> Any:
        out = fn(*args, **kwargs)
        if not (first_only and calls):
            calls.append((args, kwargs, out))
        return out

    setattr(module, name, capture)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def first_layer_operands_of(model: VAEP, batch: Any) -> Tuple[torch.Tensor, ...]:
    """The operands one ``rate_batch`` call hands B1."""
    with captured(fused_ops, 'fused_first_layer_quant') as calls:
        model.rate_batch(batch)
    return calls[0][0]


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
    device: DeviceLike = None, hidden: Tuple[int, ...] = HIDDEN, model_cls: Any = VAEP,
    head_seed: int = 100,
) -> VAEP:
    """A ``model_cls`` (VAEP or AtomicVAEP) with two seeded random MLP
    heads, carried through the converter.

    Standardization statistics are numpy means/stds of the features of a
    small seeded batch. Two choices keep the heads like trained ones, so
    the quantized bands are measured where served values live: output
    biases sit at logit(0.01) (a goal within ten actions is a rare event),
    and the ``Dense_0`` row of a one-hot column is scaled by ``min(1, 2σ)``
    (a rarely active column gets few updates, so its weight on the raw
    0/1 input stays small instead of growing as ``1/σ``). ``head_seed``
    seeds the scores head's weights (the concedes head's is one more).
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
        rng = np.random.default_rng(head_seed + seed)
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
    return {'launches': launches, 'main_b1': main_b1, 'actions_per_s': n_actions / median,
            'median_s': median}


def on_device(evt: Any) -> bool:
    """A profiler event of the card's own work: a kernel, copy or set, not
    the range a span (``torch.profiler.record_function``) marks on the
    card's timeline."""
    from torch.autograd import DeviceType

    return (evt.device_type == DeviceType.CUDA and not getattr(evt, 'is_user_annotation', False)
            and not NAME_RE.match(evt.key))


def device_breakdown(fn: Callable[[], Any], top: int = 8) -> Dict[str, Any]:
    """Device time by kernel over one synchronized call of ``fn``.

    ``torch.profiler`` with CUDA activity; kernel rows are the events on
    the device. Returns the wall milliseconds under the profiler, the
    summed kernel milliseconds and launches, and the ``top`` kernels by
    device time.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if not on_device(evt):
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
    """B2 against its plain version on the card at one shape (phase 3).

    Integer-valued sums are held bitwise to the plain version in f32. Real
    sums are held to the plain version in f64, atol/rtol 1e-5: the plain
    version in f32 adds with ``index_add_``'s atomics, one long chain a
    segment in an order that changes from run to run, and at the
    calibration shape (about 85,000 terms a bin or more) it drifts past
    1e-5 relative of the exact sum by itself; its own gap to f64 is
    reported beside the kernel's.
    """
    got = seg.segment_sum(vals, ids, s)
    want = seg.segment_sum_reference(vals, ids, s)
    exact_sums = seg.segment_sum_reference(vals, ids, s, dtype=torch.float64)
    torch.cuda.synchronize()
    if exact:
        # integer-valued f32 sums are exact in any order
        max_abs = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f'segment_sum {label}: counts differ from the plain version')
    else:
        max_abs = float((got.double() - exact_sums).abs().max())
        torch.testing.assert_close(got.double(), exact_sums, atol=1e-5, rtol=1e-5)
    plain_f32_err = float((want.double() - exact_sums).abs().max())
    ok = (ids >= 0) & (ids < s)
    ids_clean = torch.where(ok, ids, 0).long()
    vals_clean = torch.where(ok, vals, 0.0)
    n = vals.numel()
    bound_ms = seg.segment_sum_cost(n, s)[1] / PEAK_BYTES_PER_S * 1e3
    return {
        'shape': label,
        'n': n,
        'segments': s,
        'exact': exact,
        'max_abs_err': max_abs,
        'plain_f32_max_abs_err': plain_f32_err,
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


# -- the season feed (phase 9) --------------------------------------------------------


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op for the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def kernel_launches(n: int, device: torch.device) -> int:
    """The launches ``n`` calls of a kernel's wrapper count on ``device``:
    on the CPU a wrapper runs its plain version and counts none."""
    return n if device.type == 'cuda' else 0


class ArrayStore:
    """A stand-in for a ``SeasonStore`` over arrays (phase 9).

    The card's machine has no pandas, pyarrow or h5py, so it reads no
    parquet or HDF5 store; its packed caches are written from arrays.
    ``PackedSeasonWriter`` and the feed need of a store only a ``path``
    (an empty directory here, which the cache fingerprints), the game ids
    and their home teams.
    """

    def __init__(self, path: str, n_games: int) -> None:
        os.makedirs(path)
        self.path = path
        self._ids = list(range(n_games))

    def game_ids(self) -> List[int]:
        return list(self._ids)

    def home_team_ids(self) -> Dict[int, int]:
        return {g: 0 for g in self._ids}


def direct_chunk(draw: Any, lo: int, hi: int) -> Any:
    """Games ``lo:hi`` of a left-aligned host draw as the family's packer
    makes them: the rows sliced, ``game_id`` and ``row_index`` chunk-local
    (valid rows numbered in order, -1 on padding)."""
    f = {n: t[lo:hi] for n, t in draw.fields().items()}
    mask = f['mask'].numpy()
    row_index = np.full(mask.shape, -1, dtype=np.int32)
    row_index[mask] = np.arange(int(mask.sum()), dtype=np.int32)
    f['row_index'] = torch.from_numpy(row_index)
    f['game_id'] = torch.arange(hi - lo, dtype=torch.int32)
    return type(draw)(**f)


class FeedSource(NamedTuple):
    """A packed cache and how phase 9 streams it."""

    store: ArrayStore
    cache_dir: str
    games: int  # per chunk
    max_actions: int

    def epoch(self, prefetch: int, device: torch.device) -> Any:
        """One pass of ``iter_batches`` over the cache."""
        return iter_batches(self.store, self.games, max_actions=self.max_actions,
                            packed_cache=self.cache_dir, prefetch=prefetch, device=device)


def write_cache(draw: Any, store: ArrayStore, cache_dir: str, family: str, games: int) -> PackedSeason:
    """A host draw written into a packed cache, ``games`` at a time, and opened."""
    writer = PackedSeasonWriter(
        store, max_actions=draw.max_actions, cache_dir=cache_dir, family=family
    )
    for lo in range(0, draw.n_games, games):
        writer.write_chunk(lo, direct_chunk(draw, lo, min(lo + games, draw.n_games)))
    return writer.finalize()


def ragged_atomic_draw(n_games: int, n_actions: int, *, seed: int, low: int) -> AtomicActionBatch:
    """:func:`atomic_batch` on the CPU with game lengths drawn in
    ``[low, n_actions]`` and the padding zeroed as the packer leaves it."""
    batch = atomic_batch(n_games, n_actions, seed=seed, device='cpu')
    lengths = np.random.default_rng(seed + 1).integers(low, n_actions + 1, size=n_games)
    mask = np.arange(n_actions)[None, :] < lengths[:, None]
    f = {}
    for name, t in batch.fields().items():
        a = t.numpy().copy()
        if a.ndim == 2:
            a[~mask] = 0
        f[name] = torch.from_numpy(a)
    f['mask'] = torch.from_numpy(mask)
    f['n_actions'] = torch.from_numpy(lengths.astype(np.int32))
    return direct_chunk(AtomicActionBatch(**f), 0, n_games)


def assert_batch_equal(got: Any, want: Any, label: str) -> None:
    """Raise unless every field of ``got`` equals ``want``'s bit for bit
    (same dtype, same shape, same values)."""
    for name, a in got.fields().items():
        b = getattr(want, name).to(a.device)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f'{label}: field {name} differs from the directly built batch')


def masked_gap(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    """The largest |a - b| over the valid rows (values on padding rows are
    garbage by contract)."""
    return float((a - b).abs()[mask].max())


def check_epoch(
    model: VAEP, source: FeedSource, directs: List[Any], want: List[torch.Tensor],
    prefetch: int, device: torch.device, label: str,
) -> Dict[str, Any]:
    """One epoch of the feed through the entry points, every chunk held
    bitwise to its direct batch and rated, its values held to the direct
    batch's within 1e-6."""
    n, gap, values = 0, 0.0, []
    for (batch, ids), direct, ref in zip(source.epoch(prefetch, device), directs, want):
        assert_batch_equal(batch, direct, f'{label}, chunk {n}')
        v = model.rate_batch(batch)
        gap = max(gap, masked_gap(v, ref, batch.mask))
        values.append(v)
        n += 1
    if n != len(directs):
        raise RuntimeError(f'{label}: the feed yielded {n} chunks, not {len(directs)}')
    if not gap <= 1e-6:
        raise RuntimeError(f"{label}: fed values are {gap} from the direct batches' values")
    return {'chunks': n, 'max_abs_gap': gap, 'values': values}


def _stage(name: str) -> Any:
    """The ``pipeline/stage_seconds`` series of one stage, as a snapshot."""
    return REGISTRY.snapshot().series('pipeline/stage_seconds', stage=name)


def timed_epoch(model: VAEP, source: FeedSource, prefetch: int, device: torch.device) -> Dict[str, Any]:
    """One epoch, fed and rated, timed on the host's clock up to a sync.

    Returns the wall seconds, the rated actions, the consumer's time
    blocked on the feed's queue (prefetch > 0), and with ``prefetch=0``
    each chunk's ``read_cache`` and ``transfer`` seconds (the stages run
    on this thread then, so each chunk's sample is the series' last).
    """
    stages = ('feed_wait', 'read_cache', 'transfer')
    before = {k: _stage(k) for k in stages}
    samples: Dict[str, List[float]] = {'read_cache': [], 'transfer': []}
    values, actions = [], 0
    sync(device)
    t0 = time.perf_counter()
    for batch, _ in source.epoch(prefetch, device):
        values.append(model.rate_batch(batch))
        actions += batch.mask.numel()
        if prefetch == 0:
            for k in samples:
                samples[k].append(_stage(k).last)
    sync(device)
    wall = time.perf_counter() - t0
    del values

    def total(k: str) -> float:
        a, b = before[k], _stage(k)
        return (b.total if b else 0.0) - (a.total if a else 0.0)

    out = {'prefetch': prefetch, 'wall_s': wall, 'actions': actions,
           'actions_per_s': actions / wall,
           **{f'{k}_s': total(k) for k in stages}}
    out['feed_wait_share'] = out['feed_wait_s'] / wall
    if prefetch == 0:
        out.update({f'{k}_median_ms': float(np.median(v)) * 1e3 for k, v in samples.items()})
        out.update({f'{k}_ms': [x * 1e3 for x in v] for k, v in samples.items()})
    return out


def device_busy(fn: Callable[[], Any]) -> Dict[str, Any]:
    """``torch.profiler`` over one synchronized call of ``fn``: the wall
    milliseconds, the device's busy milliseconds (the union over every
    stream of its kernels and copies), its idle share, and the summed
    kernel and copy milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernel_us, copy_us = [], 0.0, 0.0
    for evt in prof.events():
        if not on_device(evt):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        if 'memcpy' in evt.name.lower():
            copy_us += end - start
        else:
            kernel_us += end - start
    spans.sort()
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return {'wall_ms': wall_ms, 'busy_ms': busy_us / 1e3, 'idle_share': 1.0 - busy_us / 1e3 / wall_ms,
            'kernel_ms': kernel_us / 1e3, 'copy_ms': copy_us / 1e3, 'device_events': len(spans)}


def pinned_copy_ms(nbytes: int, reps: int = 10) -> float:
    """Device milliseconds of one host-to-device copy of ``nbytes`` from
    pinned memory, alone on the card (CUDA events, median of ``reps``)."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device='cuda')
    dst.copy_(src, non_blocking=True)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def feed_phase(
    model: VAEP, draw: ActionBatch, fit: Dict[str, Any], device: torch.device,
    card: str = 'CPU', games: int = FEED_GAMES, atomic_low: int = 1200,
) -> Dict[str, Any]:
    """Phase 9: the draw written into a packed cache and streamed from it
    through ``iter_batches`` onto ``device``, two chunks ahead and
    synchronously; every chunk held bitwise to its direct batch and rated
    through B1; the fed epoch's times; the whole season taken at once and
    fitted (B2), held to ``fit`` (phase 5's fit of the same draw); and a
    ragged Atomic-SPADL cache taken whole, held bitwise and rated."""
    shutil.rmtree(FEED_DIR, ignore_errors=True)
    try:
        return _feed_phase(model, draw, fit, device, card, games, atomic_low)
    finally:
        shutil.rmtree(FEED_DIR, ignore_errors=True)


def _feed_phase(
    model: VAEP, draw: ActionBatch, fit: Dict[str, Any], device: torch.device, card: str,
    games: int, atomic_low: int,
) -> Dict[str, Any]:
    label = 'feed path'
    store = ArrayStore(os.path.join(FEED_DIR, 'store'), draw.n_games)
    cache_dir = os.path.join(FEED_DIR, 'cache')
    t0 = time.perf_counter()
    season = write_cache(draw, store, cache_dir, 'standard', games)
    write_s = time.perf_counter() - t0
    source = FeedSource(store, cache_dir, games, draw.max_actions)
    cache_bytes = sum(
        os.path.getsize(os.path.join(cache_dir, f)) for f in os.listdir(cache_dir)
    )
    directs = [
        direct_chunk(draw, lo, min(lo + games, draw.n_games)) for lo in range(0, draw.n_games, games)
    ]
    # the values of the direct batches: comparison launches, made before
    # the counts are zeroed
    want = [model.rate_batch(d.to(device)) for d in directs]
    print(f'{label}: packed cache of {draw.n_games} games x {draw.max_actions} actions, '
          f'{cache_bytes} bytes, written in {write_s:.3f} s')

    gm.fused_first_layer_quant.launches = 0
    main = check_epoch(model, source, directs, want, FEED_PREFETCH, device,
                       f'{label}, prefetch={FEED_PREFETCH}')
    sync(device)
    launches = gm.fused_first_layer_quant.launches
    if launches != kernel_launches(len(directs), device):
        raise RuntimeError(f'{label}: {len(directs)} chunks launched gather_matmul {launches} times')
    sync_epoch = check_epoch(model, source, directs, want, 0, device, f'{label}, prefetch=0')
    same = all(torch.equal(a, b) for a, b in zip(main['values'], sync_epoch['values']))
    if not same:
        raise RuntimeError(f'{label}: prefetch=0 and prefetch={FEED_PREFETCH} rate differently')
    print(f"{label}: {main['chunks']} chunks of {games} games, each bitwise to its direct "
          f"batch at prefetch={FEED_PREFETCH} and 0, values within {main['max_abs_gap']:.3e} of "
          f"the direct batches' (limit 1e-6), gather_matmul launches {launches}")
    del main, sync_epoch, want

    # three rounds of: an epoch two chunks ahead, one synchronous, and the
    # consumer alone (the same chunks already on the device, rated back to
    # back): the feed's cost is what an epoch adds to the consumer alone
    on_device = [d.to(device) for d in directs]
    epochs, alone = [], []
    for _ in range(3):
        epochs += [timed_epoch(model, source, p, device) for p in (FEED_PREFETCH, 0)]
        sync(device)
        t0 = time.perf_counter()
        for b in on_device:
            model.rate_batch(b)
        sync(device)
        alone.append(time.perf_counter() - t0)
    del on_device
    for e in epochs:
        print(f'{label}: epoch ({card}): {json.dumps(e)}')
    summary = {
        f'prefetch={p}': {
            'median_wall_ms': float(np.median([e['wall_s'] for e in epochs if e['prefetch'] == p])) * 1e3,
            'median_actions_per_s': float(np.median(
                [e['actions_per_s'] for e in epochs if e['prefetch'] == p])),
        }
        for p in (FEED_PREFETCH, 0)
    }
    summary['consumer alone'] = {'median_wall_ms': float(np.median(alone)) * 1e3,
                                 'wall_ms': [a * 1e3 for a in alone]}
    print(f'{label}: epochs of {draw.total_actions} actions, medians of 3 ({card}): '
          f'{json.dumps(summary)}')
    record: Dict[str, Any] = {'launches': launches, 'epochs': epochs, 'summary': summary,
                              'cache_bytes': cache_bytes}
    # stacked floats (5 x 4 bytes), int8 ids (4), flags (1) an action; lengths
    wire_bytes = games * draw.max_actions * 25 + games * 4
    if device.type == 'cuda':
        copy_ms = pinned_copy_ms(wire_bytes)
        prof = device_busy(lambda: timed_epoch(model, source, FEED_PREFETCH, device))
        record.update({'wire_bytes': wire_bytes, 'pinned_copy_ms': copy_ms,
                       'link_gb_per_s': wire_bytes / copy_ms / 1e6, 'profile': prof})
        print(f'{label}: one {wire_bytes}-byte chunk wire copied alone from pinned memory: '
              f'{copy_ms:.3f} ms, {wire_bytes / copy_ms / 1e6:.2f} GB/s ({card})')
        print(f'profile: one prefetch={FEED_PREFETCH} epoch, {json.dumps(prof)} ({card})')

    # the whole season in one take, fitted (16 x 12 dense: B2)
    whole, _ = season.take(season.game_ids, device=device)
    assert_batch_equal(whole, direct_chunk(draw, 0, draw.n_games), f'{label}, whole season')
    sync(device)
    seg.segment_sum.launches = 0
    m = ExpectedThreat(device=device).fit(whole)
    sync(device)
    fit_launches = seg.segment_sum.launches
    grid_gap = float(np.abs(m.xT - fit['grid']).max())
    if (fit_launches < kernel_launches(1, device) or m.n_iter != int(fit['iterations'])
            or not grid_gap <= 1e-6):
        raise RuntimeError(
            f'{label}: the fed fit ({m.n_iter} sweeps, {fit_launches} segment_sum launches) is '
            f'{grid_gap} from the direct fit ({int(fit["iterations"])} sweeps)'
        )
    print(f'{label}: ExpectedThreat 16x12 on the whole fed season: {m.n_iter} sweeps (direct '
          f'{int(fit["iterations"])}), max |grid - direct grid| = {grid_gap:.3e} (limit 1e-6), '
          f'segment_sum launches {fit_launches}')
    record.update({'fit_launches': fit_launches, 'fit_grid_gap': grid_gap, 'fit_sweeps': m.n_iter})
    del whole, m

    # a ragged Atomic-SPADL cache, taken whole and rated
    amodel = make_model(device, model_cls=AtomicVAEP)
    adraw = ragged_atomic_draw(games, draw.max_actions, seed=7, low=atomic_low)
    astore = ArrayStore(os.path.join(FEED_DIR, 'atomic-store'), games)
    aseason = write_cache(adraw, astore, os.path.join(FEED_DIR, 'atomic-cache'), 'atomic', games)
    adirect = direct_chunk(adraw, 0, games).to(device)
    awant = amodel.rate_batch(adirect)
    gm.fused_first_layer_quant.launches = 0
    abatch, _ = aseason.take(aseason.game_ids, device=device)
    avalues = amodel.rate_batch(abatch)
    sync(device)
    alaunches = gm.fused_first_layer_quant.launches
    assert_batch_equal(abatch, adirect, f'{label}, atomic take')
    agap = masked_gap(avalues, awant, abatch.mask)
    if alaunches != kernel_launches(1, device) or not agap <= 1e-6:
        raise RuntimeError(f'{label}: atomic take rated {agap} from its direct batch, '
                           f'{alaunches} gather_matmul launches')
    lengths = adraw.n_actions.numpy()
    print(f'{label}: atomic take of {games} games ({int(lengths.min())} to '
          f'{int(lengths.max())} actions each), bitwise to its direct batch; AtomicVAEP values '
          f"within {agap:.3e} of the direct batch's (limit 1e-6), gather_matmul launches {alaunches}")
    record.update({'atomic_launches': alaunches, 'atomic_gap': agap})
    return record


# -- counterfactuals (phase 10) --------------------------------------------------------


def scenario_phase(
    model: VAEP, device: torch.device, card: str = 'CPU', n_games: int = SCENARIO_GAMES,
    n_actions: int = ACTIONS, nx: int = SCENARIO_GRID[0], ny: int = SCENARIO_GRID[1],
    reps: int = 5,
) -> Dict[str, Any]:
    """Phase 10: ``rate_scenarios_batch`` over an end-location grid, one
    call (one launch of B1), against the loop of one ``rate_batch`` per
    perturbation and against the materialized reference on the first four
    perturbations (both within 1e-5), with the fold's and the loop's
    counterfactual values per second."""
    label = 'scenario path'
    batch = synthetic_batch(n_games, n_actions, seed=11, device=device)
    grid = end_location_grid(nx, ny)
    P = grid.n_perturbations
    gm.fused_first_layer_quant.launches = 0
    fold = rate_scenarios_batch(model, batch, grid)
    sync(device)
    fold_launches = gm.fused_first_layer_quant.launches
    if fold_launches != kernel_launches(1, device):
        raise RuntimeError(f'{label}: the fold launched gather_matmul {fold_launches} times')
    gm.fused_first_layer_quant.launches = 0
    loop = rate_scenarios_looped(model, batch, grid)
    sync(device)
    loop_launches = gm.fused_first_layer_quant.launches
    mask = batch.mask[None].expand(P, -1, -1)
    loop_gap = masked_gap(fold, loop, mask)
    sub = ScenarioGrid(field_updates={k: v[:4] for k, v in grid.field_updates.items()})
    ref = rate_scenarios_reference(model, batch, sub)
    ref_gap = masked_gap(fold[:4], ref, mask[:4])
    surface = decision_surface(fold, grid, game=0, action=10)
    if not (bool(torch.isfinite(fold[mask]).all()) and loop_gap <= 1e-5 and ref_gap <= 1e-5
            and surface.shape == (ny, nx) and np.isfinite(surface).all()):
        raise RuntimeError(f'{label}: fold vs loop {loop_gap}, vs reference {ref_gap} (limit 1e-5)')

    def median_s(fn: Callable[[], Any], n: int) -> float:
        times = []
        for _ in range(n):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    values = P * batch.total_actions
    fold_s = median_s(lambda: rate_scenarios_batch(model, batch, grid), reps)
    loop_s = median_s(lambda: rate_scenarios_looped(model, batch, grid), max(1, reps // 2))
    record = {
        'perturbations': P, 'games': n_games, 'folded_games': P * n_games, 'values': values,
        'fold_launches': fold_launches, 'loop_launches': loop_launches,
        'fold_vs_loop': loop_gap, 'fold_bitwise_loop': bool(torch.equal(fold, loop)),
        'fold_vs_reference_first4': ref_gap,
        'fold_s': fold_s, 'loop_s': loop_s,
        'fold_values_per_s': values / fold_s, 'loop_values_per_s': values / loop_s,
    }
    print(f'{label} ({card}): {json.dumps(record)}')
    return record


# -- telemetry on the card (phase 11) --------------------------------------------------


def planted(model: VAEP, plant: str) -> VAEP:
    """A copy of ``model`` with a fault planted in its scores head: a NaN
    in one first-layer weight, or the output layer scaled by 1e4 (logits
    far past 88)."""
    heads = {col: copy.deepcopy(clf) for col, clf in model._models.items()}
    layers = heads['scores'].module.layers()
    with torch.no_grad():
        if plant == 'nan':
            layers[0].weight[0, 0] = float('nan')
        else:
            layers[-1].weight.mul_(1e4)
            layers[-1].bias.mul_(1e4)
    return type(model)(models=heads, device=model.device)


def drained_guards(model: VAEP, batch: Any) -> Tuple[torch.Tensor, List[Tuple[Any, ...]]]:
    """``rate_batch`` with the pending guards cleared, its values brought to
    the host, then one drain: ``(host values, sorted guard events)``."""
    numerics.clear_pending()
    values = model.rate_batch(batch).cpu()
    events = sorted(tuple(e) for e in numerics.drain_guards())
    if numerics.pending_guards():
        raise RuntimeError(f'{numerics.pending_guards()} guards were not ready after values.cpu()')
    return values, events


@contextlib.contextmanager
def guards_off() -> Any:
    """``SOCCERACTION_TPU_NUM_GUARDS=0`` for the enclosed block."""
    prev = os.environ.get(numerics.NUM_GUARDS_ENV)
    os.environ[numerics.NUM_GUARDS_ENV] = '0'
    try:
        yield
    finally:
        if prev is None:
            del os.environ[numerics.NUM_GUARDS_ENV]
        else:
            os.environ[numerics.NUM_GUARDS_ENV] = prev


def sync_profile(fn: Callable[[], Any], device: torch.device) -> Dict[str, Any]:
    """Host reads and stream waits in one call of ``fn`` under
    ``torch.profiler``: ``aten::_local_scalar_dense`` (a tensor read to a
    host scalar) and ``cudaStreamSynchronize``/``cudaDeviceSynchronize``
    calls, the device's kernel launches, and the call's wall before and
    after a sync."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        dispatch_s = time.perf_counter() - t0
        sync(device)
        synced_s = time.perf_counter() - t0
    counts = {'aten::_local_scalar_dense': 0, 'cudaStreamSynchronize': 0, 'cudaDeviceSynchronize': 0}
    launches = 0
    for evt in prof.key_averages():
        if evt.key in counts:
            counts[evt.key] += evt.count
        if on_device(evt):
            launches += evt.count
    return {'reads': counts, 'kernel_launches': launches, 'dispatch_s': dispatch_s, 'synced_s': synced_s}


def metric_lines(prefixes: Tuple[str, ...]) -> List[Dict[str, Any]]:
    """The registry's series under ``prefixes`` that have samples."""
    out = []
    for name, inst in REGISTRY.snapshot().instruments.items():
        if not name.startswith(prefixes):
            continue
        for s in inst.series:
            if s.count:
                out.append({'metric': name, 'labels': dict(s.labels), 'count': s.count,
                            'last': s.last, 'total': s.total, 'max': s.max})
    return out


def telemetry_phase(
    model: VAEP, device: torch.device, card: str = 'CPU', games: int = GAMES,
    actions: int = ACTIONS, reps: int = 20, probes: int = 8, pairs: int = 10,
) -> Dict[str, Any]:
    """Phase 11: the port's telemetry on the main path.

    Numeric guards of ``rate_batch`` on phase 4's shape: none drained for
    the model; for a NaN-planted and an overflow-planted copy, the drained
    counts equal those of the same planted model rated on the CPU through
    the plain versions; guarded values bitwise those with the guards off.
    Host reads and stream waits of one ``rate_batch`` with guards and
    metrics on, and of the bare dispatch with guards off, must be equal.
    ``record_dispatch`` over ``reps`` synced calls: the roofline in
    (0, 1.05]. Memory gauges, the residency report with an ``xt_fleet``
    and a ``pipeline_feed`` claim held, the census within the allocator's
    bytes. ``ParityProbe`` over ``probes`` calls on its own stream (f32 ≤
    1e-5, a bf16 fold ≤ 1e-3, values offset by 1e-3 one exceedance). A
    run log and a debug bundle with the card's memory. Then the dispatch
    observatory, the builds and the cold-start report.
    """
    label = 'telemetry'
    card_dev = device.type == 'cuda'
    batch = synthetic_batch(games, actions, seed=0, device=device)
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    record: Dict[str, Any] = {}

    # -- guards
    values, events = drained_guards(model, batch)
    if events:
        raise RuntimeError(f'{label}: the clean model drained guard events {events}')
    with guards_off():
        unguarded = model.rate_batch(batch).cpu()
    if not torch.equal(values, unguarded):
        raise RuntimeError(f'{label}: guarded values differ from the unguarded ones')
    cpu_model = make_model('cpu', tuple(m.out_features for m in model._models['scores'].module.layers()[:-1]))
    cpu_batch = batch.to('cpu')
    guards = {}
    for plant in ('nan', 'overflow'):
        _, got = drained_guards(planted(model, plant), batch)
        _, want = drained_guards(planted(cpu_model, plant), cpu_batch)
        if got != want or not got:
            raise RuntimeError(f'{label}: {plant}-planted guards {got} on the card, {want} on the CPU')
        guards[plant] = {'card': got, 'cpu': want}
    record['guards'] = guards
    del cpu_model, cpu_batch
    print(f'{label}: drained guards of planted heads, card and CPU ({card}): {json.dumps(guards)}')

    # -- no telemetry sync; the guard's cost
    model.rate_batch(batch)
    with guards_off():
        model._rate(batch)
    on = sync_profile(lambda: model.rate_batch(batch), device)
    with guards_off():
        off = sync_profile(lambda: model._rate(batch), device)
    if on['reads'] != off['reads']:
        raise RuntimeError(f"{label}: telemetry changed the host reads: {on['reads']} vs {off['reads']}")
    walls: Dict[str, List[float]] = {'on': [], 'off': []}
    for i in range(pairs):
        for mode in (('on', 'off') if i % 2 == 0 else ('off', 'on')):
            scope = guards_off() if mode == 'off' else contextlib.nullcontext()
            with scope:
                sync(device)
                t0 = time.perf_counter()
                (model.rate_batch if mode == 'on' else model._rate)(batch)
                sync(device)
                walls[mode].append(time.perf_counter() - t0)
    record['sync'] = {'on': on, 'off': off,
                      'median_synced_s': {k: float(np.median(v)) for k, v in walls.items()},
                      'pairs': pairs}
    print(f"{label}: one rate_batch, telemetry on vs off ({card}): {json.dumps(record['sync'])}")

    # -- the live roofline over synced calls
    pair_cost, values_cost = fn_cost('pair_probs'), fn_cost('vaep_values')
    flops, nbytes = pair_cost[0] + values_cost[0], pair_cost[1] + values_cost[1]
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        model.rate_batch(batch)
        sync(device)
        perf = record_dispatch('pair_probs', time.perf_counter() - t0, bucket=games,
                               flops=flops, bytes_accessed=nbytes)
    roofline = {k: perf.get(k) for k in (
        'dispatches', 'last_wall_s', 'cost_flops', 'cost_bytes', 'achieved_flops',
        'achieved_bytes', 'roofline_frac', 'idle_frac')}
    roofline['pair_probs_cost'] = pair_cost
    roofline['vaep_values_cost'] = values_cost
    record['roofline'] = roofline
    print(f'{label}: record_dispatch over {reps} synced rate_batch ({card}): {json.dumps(roofline)}')
    if card_dev and not 0 < roofline['roofline_frac'] <= 1.05:
        raise RuntimeError(f"{label}: roofline_frac {roofline['roofline_frac']} outside (0, 1.05]")

    # -- memory and residency, with an xT fleet's stacks and a fed chunk held
    gid = group_ids(batch)
    fields = xt_fields(batch)
    counts = xtops.xt_counts(*fields, l=16, w=12, group_id=gid, n_groups=XT_GROUPS)
    probs = xtops.xt_probabilities(counts, l=16, w=12)
    sol = xtops.solve_xt(probs)
    fleet = claim_bytes('xt_fleet', (probs, sol.grid))
    host = ActionBatch(**{n: t.cpu().numpy() for n, t in batch.fields().items()})
    chunk = ship_host_batch(host, device=device)
    sample = sample_device_memory()
    report = residency_report()
    census = live_array_census(top=3)
    fleet.release()
    del chunk, host, sol, probs, counts
    mem = {'gauges': sample, 'residency': report, 'census_total_bytes': census.get('total_bytes')}
    record['memory'] = mem
    print(f'{label}: memory and residency ({card}): {json.dumps(mem)}')
    if card_dev:
        stats = sample[str(device.index)]
        if not all(stats[k] > 0 for k in ('bytes_in_use', 'peak_bytes_in_use', 'bytes_limit')):
            raise RuntimeError(f'{label}: memory gauges read zero: {stats}')
        if not {'xt_fleet', 'pipeline_feed'} <= set(report['owners']):
            raise RuntimeError(f"{label}: the residency report misses a claim: {report['owners']}")
        if report['census_total_bytes'] > report['allocated_bytes']:
            raise RuntimeError(f'{label}: the census counts more than the allocator holds')

    # -- the parity probe on its own stream
    probe = ParityProbe(sample_rate=1.0, max_abs_err=1e-5, queue_size=probes)
    narrow = ParityProbe(sample_rate=1.0, max_abs_err=1e-3, queue_size=2)
    try:
        for i in range(probes):
            v = model.rate_batch(batch)
            if probe.should_sample():
                probe.submit_flush(model, batch, None, v, exemplar=f'call-{i}')
        model.set_quantize('bf16')
        for i in range(2):
            narrow.submit_flush(model, batch, None, model.rate_batch(batch), exemplar=f'bf16-{i}')
        model.set_quantize('none')
        if not (probe.flush(timeout=300) and narrow.flush(timeout=300)):
            raise RuntimeError(f'{label}: the parity probe did not finish')
        f32, bf16 = probe.stats(), narrow.stats()
        probe.submit_flush(model, batch, None, model.rate_batch(batch) + 1e-3, exemplar='planted')
        if not probe.flush(timeout=300):
            raise RuntimeError(f'{label}: the parity probe did not finish the planted offset')
        planted_stats = probe.stats()
    finally:
        model.set_quantize('none')
        probe.close()
        narrow.close()
    parity = {
        'f32': {k: f32[k] for k in ('probes', 'max_abs_err', 'max_ulp_err', 'exceedances', 'errors')},
        'bf16': {k: bf16[k] for k in ('probes', 'max_abs_err', 'exceedances', 'errors')},
        'planted': {k: planted_stats[k] for k in ('probes', 'exceedances', 'errors')},
        'abs_err_series': metric_lines(('num/parity_abs_err',)),
    }
    record['parity'] = parity
    print(f'{label}: parity probe ({card}): {json.dumps(parity)}')
    if not (f32['probes'] == probes and f32['errors'] == 0 and f32['max_abs_err'] <= 1e-5
            and bf16['probes'] == 2 and bf16['max_abs_err'] <= 1e-3
            and planted_stats['exceedances'] == 1):
        raise RuntimeError(f'{label}: parity probe outside its bands: {parity}')

    # -- a run log and a debug bundle
    with tempfile.TemporaryDirectory() as tmp:
        with RunLog(tmp, config={'phase': 11, 'games': games}) as log:
            with span('smoke/telemetry', games=games) as sp:
                sp.memory()
                sp.sync(model.rate_batch(batch))
            log.metric_snapshot()
            bundle = dump_debug_bundle(tmp, reason='manual', trigger={'phase': 11})
        with open(os.path.join(tmp, 'obs.jsonl')) as f:
            log_events = [json.loads(line)['event'] for line in f]
        with tarfile.open(bundle) as tar:
            members = sorted(tar.getnames())
            memory = json.loads(tar.extractfile('memory.json').read())
    record['bundle'] = {'members': members, 'memory_supported': memory['supported'],
                        'log_events': sorted(set(log_events)), 'span_attrs': sp.attrs}
    print(f"{label}: run log and bundle ({card}): {json.dumps(record['bundle'])}")
    if members != ['manifest.json', 'memory.json', 'metrics.json', 'ring.jsonl']:
        raise RuntimeError(f'{label}: the bundle holds {members}')
    if card_dev and memory['supported'] is not True:
        raise RuntimeError(f'{label}: the bundle has no card memory: {memory}')

    # -- the dispatch observatory, the builds, the cold-start timeline
    record['dispatch'] = {fn: {'signatures': e['compiles'], 'first_call_seconds': e['compile_seconds_total'],
                               'retrace_storms': e['retrace_storms']}
                          for fn, e in observatory_snapshot().items()}
    record['builds'] = metric_lines(('dispatch/kernel_builds', 'dispatch/build_seconds'))
    record['coldstart'] = coldstart_report()
    record['launches'] = {'gather_matmul': gm.fused_first_layer_quant.launches,
                          'segment_sum': seg.segment_sum.launches}
    print(f"{label}: dispatch observatory ({card}): {json.dumps(record['dispatch'])}")
    print(f"{label}: kernel builds ({card}): {json.dumps(record['builds'])}")
    print(f"{label}: cold start of this process ({card}): {json.dumps(record['coldstart'])}")
    print(f"{label}: launches {json.dumps(record['launches'])}")
    return record


# -- the rating dispatch and the gate's statistics (phase 12) -------------------------

#: Paths phase 12 forces through ``SOCCERACTION_TPU_RATING_PATH``, with the
#: launches of B1 one ``rate_batch`` call makes on each.
PATH_LAUNCHES = {'fused': 1, 'fused_bf16': 1, 'materialized': 0}
#: Bootstrap resamples of phase 12's shadow replay (the gate's default).
N_BOOT = 200
#: The env variable that forces a rating path (``ops/profile.py``).
RATING_PATH_ENV = 'SOCCERACTION_TPU_RATING_PATH'


@contextlib.contextmanager
def forced_path(path: str) -> Any:
    """``SOCCERACTION_TPU_RATING_PATH=path`` for the enclosed block."""
    prev = os.environ.get(RATING_PATH_ENV)
    os.environ[RATING_PATH_ENV] = path
    try:
        yield
    finally:
        if prev is None:
            del os.environ[RATING_PATH_ENV]
        else:
            os.environ[RATING_PATH_ENV] = prev


def synced_median(fn: Callable[[], Any], device: torch.device, reps: int = 5) -> float:
    """Median wall seconds of ``fn`` up to a sync, over ``reps`` calls
    after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def make_seq_head(model_cls: Any, device: torch.device, seed: int = 0) -> SeqClassifier:
    """A seq head at the default widths (32, 64, 64) with its seeded init and
    the full-column statistics of a small seeded batch."""
    names = model_cls._default_xfns
    registry = fused_ops.REGISTRIES[model_cls._fused_registry]
    sample = make_batch(model_cls, 8, ACTIONS, seed=1, device=device)
    states, layout = fused_ops.build_train_states(sample, names=names, k=K, registry=registry)
    mean, std = fused_ops.packed_feature_stats(states, layout)
    clf = SeqClassifier(seed=seed, device=device)
    clf.module = clf.init_params(layout)
    clf.mean_, clf.std_ = mean, torch.where(std > 0, std, 1.0)
    return clf


def path_matrix(
    model: VAEP, batch: Any, device: torch.device, card: str, label: str, reps: int = 5
) -> Dict[str, Any]:
    """``rate_batch`` forced onto each path in :data:`PATH_LAUNCHES`: B1's
    launches counted from 0 around one call, the f32 paths held within
    1e-5 of ``rate_batch_reference`` and ``fused_bf16`` within 0.05 of
    ``fused``, the host reads and stream waits of one call (0 and 0), and a
    synced median of ``reps`` calls as actions/s."""
    ref = model.rate_batch_reference(batch)
    n_actions = batch.total_actions
    out: Dict[str, Any] = {}
    f32 = None
    for path, want_launches in PATH_LAUNCHES.items():
        with forced_path(path):
            model.rate_batch(batch)  # the fold, a first launch
            sync(device)
            gm.fused_first_layer_quant.launches = 0
            values = model.rate_batch(batch)
            sync(device)
            launches = gm.fused_first_layer_quant.launches
            if launches != kernel_launches(want_launches, device):
                raise RuntimeError(f'{label}: {path} launched gather_matmul {launches} times')
            if path == 'fused_bf16':
                err, limit = float((values - f32).abs().max()), 0.05
            else:
                err, limit = float((values - ref).abs().max()), 1e-5
            if path == 'fused':
                f32 = values
            if not (bool(torch.isfinite(values).all()) and err <= limit):
                raise RuntimeError(f'{label}: {path} is {err} from its reference (limit {limit})')
            reads = sync_profile(lambda: model.rate_batch(batch), device)['reads']
            if reads['aten::_local_scalar_dense'] or reads['cudaStreamSynchronize']:
                raise RuntimeError(f'{label}: {path} read the card back: {reads}')
            median = synced_median(lambda: model.rate_batch(batch), device, reps)
        out[path] = {'launches': launches, 'max_abs_err': err, 'limit': limit, 'reads': reads,
                     'median_ms': median * 1e3, 'actions_per_s': n_actions / median}
        print(f'{label}: {path} ({card}): {json.dumps(out[path])}')
    winner = max(('fused', 'materialized'), key=lambda p: out[p]['actions_per_s'])
    committed = preferred_rating_path(device.type, respect_env=False)
    print(
        f'{label}: measured winner {winner} ({out["fused"]["actions_per_s"]:.1f} fused, '
        f'{out["materialized"]["actions_per_s"]:.1f} materialized actions/s); the committed '
        f'{device.type} profile picks {committed}: {"agrees" if committed == winner else "disagrees"}'
    )
    return {'paths': out, 'winner': winner, 'committed': committed}


def check_phase12_kernels(model: VAEP, batch: Any, device: torch.device) -> Dict[str, Any]:
    """Each kernel against its plain version at the shapes phase 12 hands
    it, captured from one more call of each entry outside the counted runs:
    B1 under ``predict_proba_device_batch`` (one 128-wide head), B2 under
    the calibration point sums and the drift histograms."""
    head = model._models['scores']
    with captured(fused_ops, 'fused_first_layer') as b1:
        head.predict_proba_device_batch(batch, names=model.xfns, k=K)
    ops = b1[0][0]
    got = gm.fused_first_layer_quant(*ops)
    want = gm.fused_first_layer_reference(*ops)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    tables, _, _, ids, x = ops
    b1_rec = {
        'entry': 'predict_proba_device_batch',
        'shape': {'n': ids.shape[0], 'k': ids.shape[1], 'r': tables.shape[1], 'h': tables.shape[2],
                  'd': x.shape[1]},
        'max_abs_err': float((got - want).abs().max()),
        'ms': graph_ms(lambda: gm.fused_first_layer_quant(*ops), reps=10),
        'plain_ms': time_ms(lambda: gm.fused_first_layer_reference(*ops), reps=5),
        **first_layer_bound(ops),
    }
    del got, want
    probs = {c: p for c, p in replay_probs(model, batch).items()}
    labels = model.compute_labels_batch(batch)[0]
    with captured(learn_calibration, 'segment_sum') as cal:
        learn_calibration.reliability_curve(probs['scores'], labels, batch.mask)
    with captured(learn_drift, 'segment_sum') as dft:
        DriftWatch.from_batch(model, batch)
    b2_recs = []
    for label, (vals, seg_ids, n_seg), exact in (
        ('calibration: (w, w·p, w·y) into 3 x 10 bins', cal[0][0], False),
        ('drift: 10 rows into 10 x 16 bins', dft[0][0], True),
    ):
        b2_recs.append(check_segment_sum(label, n_seg, vals.reshape(-1).float().contiguous(),
                                         seg_ids.reshape(-1).contiguous(), exact))
    return {'gather_matmul': b1_rec, 'segment_sum': b2_recs}


class GivenProbs:
    """A stand-in model for the statistics whose heads' probabilities are
    given (the card's, moved to the CPU): ``replay_probs`` of it returns
    them, so the CPU's statistics read the card's inputs exactly."""

    def __init__(self, probs: Dict[str, torch.Tensor]) -> None:
        self._models: Dict[str, Any] = {}
        self._probs = probs

    def _estimate_probabilities_batch(self, feats: Any, batch: Any = None) -> Dict[str, torch.Tensor]:
        return self._probs


def stats_phase(
    model: VAEP, batch: Any, device: torch.device, card: str, n_boot: int = N_BOOT
) -> Dict[str, Any]:
    """The gate's statistics on the card against the port's on the CPU, over
    the same inputs (the card's probabilities): ``shadow_replay`` of the
    batch (``n`` bitwise; ECE, Brier and its decomposition, and the
    intervals within 1e-6), then a drift reference and ``DriftWatch.check``
    of the batch and of a copy shifted in ``start_x`` (edges and
    proportions within 1e-6, PSI and KS within 1e-6, ``triggered``
    equal). B2's launches and the walls are printed."""
    label = 'statistics'
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    shadow = shadow_replay(model, batch=batch, n_boot=n_boot)
    shadow_s = time.perf_counter() - t0
    shadow_launches = seg.segment_sum.launches
    cpu_batch = batch.to('cpu')
    labels = dict(zip(('scores', 'concedes'), (t.cpu() for t in model.compute_labels_batch(batch))))
    weights = cpu_batch.mask.to(torch.float32)
    t0 = time.perf_counter()
    cpu_summaries = {
        col: calibration_summary(p.cpu(), labels[col], weights, n_boot=n_boot, device='cpu')
        for col, p in shadow.probs.items()
    }
    cpu_s = time.perf_counter() - t0
    gaps: Dict[str, float] = {}
    for col, s in shadow.summaries.items():
        got, want = s.to_dict(), cpu_summaries[col].to_dict()
        if got['n'] != want['n']:
            raise RuntimeError(f"{label}: {col} n {got['n']} on the card, {want['n']} on the CPU")
        for key in ('ece', 'brier', 'brier_reliability', 'brier_resolution', 'brier_uncertainty',
                    'ece_ci', 'brier_ci'):
            gap = float(np.max(np.abs(np.subtract(got[key], want[key]))))
            gaps[f'{col}.{key}'] = gap
            if gap > 1e-6:
                raise RuntimeError(f'{label}: {col} {key} is {gap} from the CPU (limit 1e-6)')
    print(f'{label}: card vs CPU gaps {json.dumps(gaps)}')
    print(
        f'{label}: shadow_replay {batch.total_actions} actions, {n_boot} resamples: '
        f'{shadow_s:.3f} s on the card, B2 {shadow_launches} launches; the CPU statistics '
        f'{cpu_s:.3f} s; largest gap {max(gaps.values()):.3e} (limit 1e-6) ({card}); '
        f'{json.dumps(shadow.to_dict())}'
    )

    shifted = dataclasses.replace(batch, start_x=batch.start_x * 0.2 + 80.0).with_total(
        batch.total_actions
    )
    cpu_shifted = shifted.to('cpu')
    cfg = DriftConfig()
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    watch = DriftWatch.from_batch(model, batch, cfg)
    results = [watch.check(model, batch), watch.check(model, shifted)]
    sync(device)
    drift_s = time.perf_counter() - t0
    drift_launches = seg.segment_sum.launches
    given = [GivenProbs({c: p.cpu() for c, p in replay_probs(model, b).items()})
             for b in (batch, shifted)]
    cpu_watch = DriftWatch.from_batch(given[0], cpu_batch, cfg)
    cpu_results = [cpu_watch.check(given[0], cpu_batch), cpu_watch.check(given[1], cpu_shifted)]
    ref_gap = max(
        float(np.abs(getattr(watch.reference, k) - getattr(cpu_watch.reference, k)).max())
        for k in ('lo', 'hi', 'props')
    )
    # PSI reaches about 9 on the shifted copy, where one f32 ulp is 9.5e-7:
    # the statistics are held relative to max(1, |value|)
    stat_gap = max(
        abs(getattr(r, stat)[name] - getattr(c, stat)[name]) / max(1.0, abs(getattr(c, stat)[name]))
        for r, c in zip(results, cpu_results) for stat in ('psi', 'ks') for name in r.psi
    )
    if ref_gap > 1e-6 or stat_gap > 1e-6:
        raise RuntimeError(f'{label}: drift card vs CPU: reference {ref_gap}, statistics {stat_gap}')
    if [r.triggered for r in results] != [c.triggered for c in cpu_results]:
        raise RuntimeError(f'{label}: drift triggered differently on the card and the CPU')
    if results[0].triggered or not results[1].triggered:
        raise RuntimeError(f'{label}: drift triggered {[r.triggered for r in results]}, want [False, True]')
    print(
        f'{label}: drift reference + 2 checks ({len(watch.reference.names)} rows x {cfg.n_bins} '
        f'bins): {drift_s:.3f} s on the card, B2 {drift_launches} launches; card vs CPU: '
        f'reference {ref_gap:.3e}, PSI/KS {stat_gap:.3e} relative (limit 1e-6); max PSI '
        f'{results[0].max_psi:.3e} same traffic, {results[1].max_psi:.3f} shifted '
        f'({results[1].max_psi_feature}) ({card})'
    )
    return {'shadow_launches': shadow_launches, 'drift_launches': drift_launches,
            'shadow_s': shadow_s, 'drift_s': drift_s, 'max_gap': max(max(gaps.values()), ref_gap, stat_gap)}


def rating_phase(
    device: torch.device, card: str = 'CPU', games: int = GAMES, actions: int = ACTIONS,
    reps: int = 5, n_boot: int = N_BOOT,
) -> Dict[str, Any]:
    """Phase 12: the rating dispatch and the gate's statistics.

    (a) :func:`path_matrix` on the standard and the atomic family with
    (128, 128) MLP heads; (b) a mixed pair (phase 4's MLP scores head, a
    seq concedes head at 32/64/64) on the materialized path, within 1e-5 of
    its reference, timed; (c) ``predict_proba_device_batch``: the MLP entry
    one launch of B1 and within 1e-5 of ``predict_proba_device`` over the
    feature tensor, the seq entry within 1e-6 of ``predict_proba_states``;
    (d) :func:`stats_phase` on the standard batch.
    """
    label = 'rating paths'
    record: Dict[str, Any] = {}
    batch = synthetic_batch(games, actions, seed=0, device=device)
    model = make_model(device)
    record['standard'] = path_matrix(model, batch, device, card, f'{label} (standard)', reps)
    abatch = atomic_batch(games, actions, seed=0, device=device)
    record['atomic'] = path_matrix(make_model(device, model_cls=AtomicVAEP), abatch, device, card,
                                   f'{label} (atomic)', reps)
    del abatch

    mixed = VAEP(models={'scores': model._models['scores'],
                         'concedes': make_seq_head(VAEP, device)}, device=device)
    if mixed._rating_path() != 'materialized':
        raise RuntimeError(f'{label}: a mixed pair rates on {mixed._rating_path()}')
    values = mixed.rate_batch(batch)
    err = float((values - mixed.rate_batch_reference(batch)).abs().max())
    if not (bool(torch.isfinite(values).all()) and err <= 1e-5):
        raise RuntimeError(f'{label}: the mixed pair is {err} from its reference')
    median = synced_median(lambda: mixed.rate_batch(batch), device, reps)
    record['mixed'] = {'max_abs_err': err, 'median_ms': median * 1e3,
                       'actions_per_s': batch.total_actions / median}
    print(f"{label}: mixed MLP/seq pair ({card}): {json.dumps(record['mixed'])}")

    names = model.xfns
    head = model._models['scores']
    gm.fused_first_layer_quant.launches = 0
    probs = head.predict_proba_device_batch(batch, names=names, k=K)
    sync(device)
    launches = gm.fused_first_layer_quant.launches
    if launches != kernel_launches(1, device):
        raise RuntimeError(f'{label}: predict_proba_device_batch launched B1 {launches} times')
    plain = head.predict_proba_device(model.compute_features_batch(batch))
    mlp_err = float((probs - plain)[batch.mask].abs().max())
    seq_head = mixed._models['concedes']
    seq_probs = seq_head.predict_proba_device_batch(batch, names=names, k=K)
    states, layout = fused_ops.build_train_states(batch, names=names, k=K)
    seq_plain = seq_head.predict_proba_states(states, layout).reshape(seq_probs.shape)
    seq_err = float((seq_probs - seq_plain)[batch.mask].abs().max())
    if mlp_err > 1e-5 or seq_err > 1e-6:
        raise RuntimeError(f'{label}: predict_proba_device_batch mlp {mlp_err}, seq {seq_err}')
    record['predict_proba_device_batch'] = {
        'launches': launches, 'mlp_max_abs_err': mlp_err, 'seq_max_abs_err': seq_err,
        'mlp_median_ms': synced_median(
            lambda: head.predict_proba_device_batch(batch, names=names, k=K), device, reps) * 1e3,
    }
    print(f"{label}: predict_proba_device_batch ({card}): "
          f"{json.dumps(record['predict_proba_device_batch'])}")
    del mixed, plain, probs, seq_probs, seq_plain, states

    record['statistics'] = stats_phase(model, batch, device, card, n_boot)
    if device.type == 'cuda':
        record['kernels'] = check_phase12_kernels(model, batch, device)
        print(f"{label}: kernels at phase 12's shapes vs plain ({card}): {json.dumps(record['kernels'])}")
    fused_paths = sum(
        record[f]['paths'][p]['launches'] for f in ('standard', 'atomic') for p in PATH_LAUNCHES
    )
    record['launches'] = {
        'gather_matmul': fused_paths + launches,
        'segment_sum': record['statistics']['shadow_launches'] + record['statistics']['drift_launches'],
    }
    print(f"{label}: launches {json.dumps(record['launches'])}")
    return record


# -- the continuous-learning loop (phase 13) -------------------------------------------

#: Phase 13's season: 20 teams over 38 rounds; the last round's games land
#: after the bootstrap.
LOOP_GAMES, LOOP_NEW_GAMES = 380, 10
#: The loop's feed chunk and its fallback replay window.
LOOP_GAMES_PER_BATCH, LOOP_REPLAY_GAMES = 64, 16
#: Phase 6's schedule: (128, 128) heads, minibatches of 8192, 3 epochs, lr 3e-4.
LOOP_PARAMS = {**TRAIN_PARAMS, 'learning_rate': 3e-4}
#: The journal's stage grammar for each verdict.
JOURNAL_STAGES = {
    'promoted': ['consumed', 'verdict', 'intent_publish', 'published', 'activated'],
    'rejected': ['consumed', 'verdict'],
}
LOOP_DIR = os.path.join('build', 'learn')


class LandingStore(ArrayStore):
    """:class:`ArrayStore` whose games land over time: each landed game
    writes a marker file, so the store's fingerprint moves and the packed
    cache reads as stale until it is brought up to date."""

    def __init__(self, path: str, n_games: int) -> None:
        super().__init__(path, 0)
        self.land(n_games)

    def land(self, n: int) -> List[int]:
        new = list(range(len(self._ids), len(self._ids) + n))
        for g in new:
            with open(os.path.join(self.path, f'game_{g}.landed'), 'w') as f:
                f.write(str(g))
        self._ids.extend(new)
        return new


def update_cache(draw: Any, store: LandingStore, cache_dir: str, chunk: int = 64) -> int:
    """Bring the packed cache up to date with the landed games: the old
    cache's rows copied (``PackedSeasonWriter.seed_from``), the new games
    (the store's tail: it only appends) written from the draw in chunks;
    returns the rows copied."""
    old = PackedSeason(cache_dir) if os.path.isdir(cache_dir) else None
    writer = PackedSeasonWriter(store, max_actions=draw.max_actions, cache_dir=cache_dir)
    reused = writer.seed_from(old) if old is not None else 0
    n = len(store.game_ids())
    for lo in range(reused, n, chunk):
        writer.write_chunk(lo, direct_chunk(draw, lo, min(lo + chunk, n)))
    writer.finalize()
    return reused


class ArrayLearner(ContinuousLearner):
    """The port's learner over a :class:`LandingStore`: the replay window
    and the drift reference's games come from the packed cache (the card's
    machine packs no DataFrames), chosen as the learner chooses stored
    games (the newest ``fallback_replay_games``, excluding the new ones).
    Keeps each trained candidate for the checks."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self.trained: List[Any] = []
        super().__init__(*args, **kwargs)

    def _cache(self) -> PackedSeason:
        cfg = self.config
        season = open_packed(self.store, max_actions=cfg.max_actions, cache_dir=cfg.cache_dir)
        if season is None:
            raise RuntimeError('the packed cache is not up to date with the store')
        return season

    def _pack_games(self, ids: Any) -> Any:
        return self._cache().take(list(ids), device=self.device)[0]

    def _replay_batch(self, exclude: Any = ()) -> Tuple[Optional[Any], str]:
        n = int(self.config.fallback_replay_games)
        exclude = set(exclude)
        all_ids = self.store.game_ids()
        ids = newest_game_ids([g for g in all_ids if g not in exclude], n)
        source = 'store_fallback'
        if not ids and exclude:
            ids, source = newest_game_ids(all_ids, n), 'store_fallback_in_sample'
        return (self._pack_games(ids) if ids else None), source

    def _train_candidate(self, active_model: Any) -> Any:
        candidate = super()._train_candidate(active_model)
        self.trained.append(candidate)
        return candidate


def loop_iteration(
    learner: ArrayLearner, device: torch.device, card: str, label: str
) -> Dict[str, Any]:
    """One ``run_once`` with both kernels' counts zeroed just before and read
    just after, synchronized, its shadow replays recorded; the verdict, the
    stage seconds, the wall, the launches and the journal's stage sequence
    of the iteration."""
    journal_len = len(learner.journal.entries())
    active = learner._active()
    sync(device)
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    with captured(loop_mod, 'shadow_replay') as shadows, \
            captured(fused_ops, 'fused_first_layer', first_only=True) as b1:
        t0 = time.perf_counter()
        report = learner.run_once()
        sync(device)
        wall = time.perf_counter() - t0
    launches = {'gather_matmul': gm.fused_first_layer_quant.launches,
                'segment_sum': seg.segment_sum.launches}
    stages = [e['stage'] for e in learner.journal.entries()[journal_len:]]
    rec = {
        'verdict': report.verdict, 'version': report.candidate_version,
        'reasons': report.reasons, 'replay': report.replay, 'wall_s': wall,
        'stage_seconds': report.stage_seconds, 'launches': launches, 'journal': stages,
        'heads': {c: {k: e.get(k) for k in ('delta_ece', 'delta_brier')}
                  for c, e in report.heads.items()},
    }
    print(f'{label} ({card}): {json.dumps(rec)}')
    if stages != JOURNAL_STAGES.get(report.verdict):
        raise RuntimeError(f'{label}: journal stages {stages} for verdict {report.verdict}')
    if device.type == 'cuda' and (launches['segment_sum'] < 1 or (
            learner.config.train_params.get('max_epochs', 1) > 0 and launches['gather_matmul'] < 1)):
        raise RuntimeError(f'{label}: the iteration did not launch the kernels: {launches}')
    rec.update(report=report, active=active, shadows=shadows,
               b1_operands=b1[0][0] if b1 else None)
    return rec


def loop_statistics(rec: Dict[str, Any], gate: GateConfig, label: str) -> Tuple[float, float]:
    """The iteration's shadow statistics held to the port's on the CPU over
    the card's probabilities, in f64: ``n`` bitwise, the rest within 1e-6.
    (A long f32 sum in another order is no reference: the CPU's f32
    statistics, whose gap is returned beside, sum a bin's about 13,000
    probabilities near 0.5 of a degraded head one after another and drift
    by about 1e-6 of ECE.) Returns the largest gaps to f64 and to f32."""
    results = {'candidate': rec['shadows'][0]}
    if len(rec['shadows']) > 1:
        results['active'] = rec['shadows'][1]
    gaps: Dict[str, float] = {}
    f32_gap = 0.0
    keys = ('ece', 'brier', 'brier_reliability', 'brier_resolution', 'brier_uncertainty',
            'ece_ci', 'brier_ci')
    for which, (args, kwargs, res) in results.items():
        model, batch = args[0], kwargs['batch']
        labels = dict(zip(('scores', 'concedes'),
                          (t.cpu() for t in model.compute_labels_batch(batch))))
        weights = batch.mask.to(torch.float32).cpu()
        for col, probs in res.probs.items():
            got = rec['report'].heads[col][which]
            for dtype in (torch.float64, torch.float32):
                want = calibration_summary(
                    probs.cpu(), labels[col], weights, n_bins=gate.n_bins, n_boot=gate.n_boot,
                    seed=gate.seed, ci_level=gate.ci_level, device='cpu', _dtype=dtype,
                ).to_dict()
                if got['n'] != want['n']:
                    raise RuntimeError(f"{label}: {which} {col} n {got['n']}, CPU {want['n']}")
                for key in keys:
                    gap = float(np.max(np.abs(np.subtract(got[key], want[key]))))
                    if dtype == torch.float64:
                        gaps[f'{which}.{col}.{key}'] = gap
                    else:
                        f32_gap = max(f32_gap, gap)
    worst = max(gaps.values())
    if worst > 1e-6:
        raise RuntimeError(f'{label}: shadow statistics card vs CPU f64 {json.dumps(gaps)} (limit 1e-6)')
    return worst, f32_gap


def _live_storages() -> Dict[Tuple[int, int], Tuple[int, str]]:
    """Every CUDA storage a live tensor holds: ``(device, pointer) ->
    (bytes, dtype and shape of the first tensor seen on it)``."""
    out: Dict[Tuple[int, int], Tuple[int, str]] = {}
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
        except ReferenceError:  # a dead weakref proxy has no class to test
            continue
        st = obj.untyped_storage()
        out.setdefault((st.device.index, st.data_ptr()),
                       (st.nbytes(), f'{obj.dtype} {tuple(obj.shape)}'))
    return out


def load_residency(registry: ModelRegistry, version: str, device: torch.device) -> Dict[str, Any]:
    """``registry.load('vaep', version)`` and the card bytes it keeps: the
    claim, the allocator's delta of requested bytes (what the load asked
    for and did not free) and of allocated bytes (the blocks that serve
    them: the caching allocator hands out a cached block up to 1 MiB
    larger than a large request whole), and the new live storages the
    claim does not cover. The deltas are ``None`` on the CPU."""
    cuda = device.type == 'cuda'
    if cuda:
        sync(device)
        before, stats0 = _live_storages(), torch.cuda.memory_stats(device)
    model = registry.load('vaep', version)
    out: Dict[str, Any] = {'claimed_bytes': registry._claims[('vaep', version)].nbytes,
                           'requested_delta_bytes': None, 'allocated_delta_bytes': None,
                           'unclaimed_bytes': 0, 'unclaimed': []}
    if cuda:
        sync(device)
        stats1 = torch.cuda.memory_stats(device)
        for key in ('requested', 'allocated'):
            stat = f'{key}_bytes.all.current'
            out[f'{key}_delta_bytes'] = stats1[stat] - stats0[stat]
        claimed = {(a.untyped_storage().device.index, a.untyped_storage().data_ptr())
                   for a in registry._resident_arrays(model)}
        new = [v for k, v in _live_storages().items() if k not in before and k not in claimed]
        out['unclaimed_bytes'] = sum(n for n, _ in new)
        out['unclaimed'] = sorted(new, reverse=True)[:5]
    return out


def learn_phase(
    device: torch.device, card: str = 'CPU', games: int = LOOP_GAMES,
    new_games: int = LOOP_NEW_GAMES, actions: int = ACTIONS,
    games_per_batch: int = LOOP_GAMES_PER_BATCH, replay_games: int = LOOP_REPLAY_GAMES,
    params: Optional[Dict[str, Any]] = None, n_boot: int = N_BOOT, rate_games: int = GAMES,
) -> Dict[str, Any]:
    """Phase 13: the continuous-learning loop with ``service=None``.

    A seeded season (``games`` x ``actions``) of which all but the last
    ``new_games`` are stored; its packed cache written from the arrays. (1)
    A bootstrap iteration: promoted, version 1. (2) The last round lands
    (the cache brought up to date: old rows seeded, new games written) and
    a warm-started iteration runs. (3) A degraded candidate (fresh init, 0
    epochs) on the same games: rejected, staged, the backlog bounded. (4)
    ``rollback``: the previous version active. Each iteration's journal
    stages, stage seconds, wall, launches and shadow statistics (held to
    the CPU's); every promoted version loaded by a fresh registry from disk
    (no ``msgpack``), its claimed bytes beside the allocator's delta, and
    rating a ``rate_games`` x ``actions`` batch bitwise as the candidate it
    was; B1 at the loop's training shape against its plain version.
    """
    label = 'learning loop'
    t_phase = time.perf_counter()
    params = dict(LOOP_PARAMS if params is None else params)
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    os.makedirs(LOOP_DIR)
    try:
        draw = synthetic_batch(games, actions, seed=13, device='cpu')
        store = LandingStore(os.path.join(LOOP_DIR, 'store'), games - new_games)
        cache_dir = os.path.join(LOOP_DIR, 'cache')
        update_cache(draw, store, cache_dir)
        registry = ModelRegistry(os.path.join(LOOP_DIR, 'registry'), device=device)
        base = dict(
            model_name='vaep', max_actions=actions, games_per_batch=games_per_batch,
            random_state=0, fallback_replay_games=replay_games, cache_dir=cache_dir,
            gate=GateConfig(n_boot=n_boot, max_ece_regression=0.05, max_brier_regression=0.02),
            drift=DriftConfig(), journal_path=os.path.join(LOOP_DIR, 'journal.jsonl'),
            debug_dir=os.path.join(LOOP_DIR, 'debug'),
        )
        good_cfg = LearnConfig(**base, train_params=params)
        bad_cfg = LearnConfig(**{**base, 'warm_start': False},
                              train_params={**params, 'max_epochs': 0})
        print(f'{label}: {games - new_games} of {games} games stored, cache written, '
              f'{time.perf_counter() - t_phase:.1f} s')

        iters = {}
        boot = ArrayLearner(store, registry, config=good_cfg)
        iters['bootstrap'] = loop_iteration(boot, device, card, f'{label}: bootstrap')
        if (iters['bootstrap']['verdict'], iters['bootstrap']['version']) != ('promoted', '1'):
            raise RuntimeError(f'{label}: the bootstrap iteration was not promoted as version 1')
        good = ArrayLearner(store, registry, config=good_cfg)
        bad = ArrayLearner(store, registry, config=bad_cfg)
        landed = store.land(new_games)
        reused = update_cache(draw, store, cache_dir)
        print(f'{label}: {len(landed)} games landed, {reused} cached rows reused')
        iters['warm'] = loop_iteration(good, device, card, f'{label}: warm-started')
        if sorted(iters['warm']['report'].new_games) != landed:
            raise RuntimeError(f'{label}: the warm-started iteration trained on other games')
        iters['degraded'] = loop_iteration(bad, device, card, f'{label}: degraded')
        tag = iters['degraded']['report'].candidate_tag
        staged = registry.candidates('vaep')
        if iters['degraded']['verdict'] != 'rejected' or tag not in staged \
                or len(staged) > bad_cfg.retention_keep:
            raise RuntimeError(
                f"{label}: the degraded candidate gave {iters['degraded']['verdict']}, staged {staged}"
            )
        before = registry.active()[:2]
        rolled = good.rollback()
        if registry.active()[:2] != rolled or rolled[1] != iters['bootstrap']['version']:
            raise RuntimeError(f'{label}: rollback from {before} made {registry.active()[:2]} active')
        print(f'{label}: rollback {before} -> {rolled}; staged candidates {staged}')

        gaps = {name: loop_statistics(rec, good_cfg.gate, f'{label}: {name}')
                for name, rec in iters.items() if rec['shadows']}
        stats_gap = max(g[0] for g in gaps.values())
        print(f'{label}: shadow statistics card vs the CPU in f64 (limit 1e-6) and in f32, '
              f'largest gaps {json.dumps(gaps)} ({card})')

        # every promoted version, read back from disk by a fresh registry
        rate_batch = synthetic_batch(rate_games, actions, seed=0, device=device)
        fresh = ModelRegistry(registry.root, device=device)
        candidates = {rec['version']: learner.trained[-1]
                      for rec, learner in ((iters['bootstrap'], boot), (iters['warm'], good))
                      if rec['version'] is not None}
        loads = {}
        for version, candidate in candidates.items():
            manifest = fresh.load_manifest('vaep', version)
            if manifest['drift_reference'] is None or len(manifest['trained_game_ids']) != (
                    games - new_games if version == '1' else games):
                raise RuntimeError(f'{label}: version {version} manifest {sorted(manifest)}')
            loads[version] = load_residency(fresh, version, device)
            loaded = fresh.load('vaep', version)
            gap = float((loaded.rate_batch(rate_batch) - candidate.rate_batch(rate_batch)).abs().max())
            loads[version].update(max_abs_gap=gap, msgpack_loaded='msgpack' in sys.modules)
            res = loads[version]
            if gap != 0.0 or res['msgpack_loaded'] or res['unclaimed_bytes'] or (
                    res['requested_delta_bytes'] not in (None, res['claimed_bytes'])):
                raise RuntimeError(f'{label}: version {version} loaded: {res}')
        print(f'{label}: registry.load from disk, rated {rate_batch.total_actions} actions '
              f'against the in-memory candidates ({card}): {json.dumps(loads)}')

        kernel = None
        ops = iters['warm']['b1_operands']
        if device.type == 'cuda' and ops is not None:
            ops = tuple(t.detach() for t in ops)
            got = gm.fused_first_layer_quant(*ops)
            want = gm.fused_first_layer_reference(*ops)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
            tables, _, _, ids, x = ops
            kernel = {
                'shape': {'n': ids.shape[0], 'k': ids.shape[1], 'r': tables.shape[1],
                          'h': tables.shape[2], 'd': x.shape[1]},
                'max_abs_err': float((got - want).abs().max()),
                'ms': graph_ms(lambda: gm.fused_first_layer_quant(*ops), reps=50),
                'plain_ms': graph_ms(lambda: gm.fused_first_layer_reference(*ops), reps=20),
                **first_layer_bound(ops),
            }
            print(f'{label}: kernel gather_matmul at the loop\'s training shape vs plain ({card}): '
                  f'{json.dumps(kernel)}')
        launches = {k: sum(rec['launches'][k] for rec in iters.values())
                    for k in ('gather_matmul', 'segment_sum')}
        summary = {name: {k: rec[k] for k in ('verdict', 'version', 'wall_s', 'stage_seconds',
                                                 'launches', 'journal')}
                   for name, rec in iters.items()}
        print(f'{label}: {json.dumps(summary)}; phase 13 in {time.perf_counter() - t_phase:.1f} s')
        return {'launches': launches, 'iterations': summary, 'loads': loads,
                'stats_gap': stats_gap, 'kernel': kernel}
    finally:
        shutil.rmtree(LOOP_DIR, ignore_errors=True)


# -- the scale-out layer (phase 14) ----------------------------------------------------

#: Full-batch steps of the distributed train step and of ``train_distributed``
#: in a world of one (a), and of each two-rank run (b).
SCALE_STEPS, SCALE_RANK_STEPS = 3, 2
#: Seconds phase 14 (b)'s two ranks may take, start to end.
SCALE_RANK_TIMEOUT_S = 420.0
#: Where phase 14 (b)'s ranks write their results (git-ignored, removed).
SCALE_DIR = os.path.join('build', 'scale')


class ScaleSizes(NamedTuple):
    """Phase 14's shapes: the xT draw, the training and rating batch, the heads."""

    xt_games: int = XT_GAMES
    games: int = GAMES
    actions: int = ACTIONS
    hidden: Tuple[int, ...] = HIDDEN


def counted(device: torch.device, fn: Callable[[], Any]) -> Tuple[Any, Dict[str, Any]]:
    """``fn()`` with both kernels' counts zeroed just before it and read
    just after, and its wall time, synchronized on the card."""
    sync(device)
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, {
        'gather_matmul': gm.fused_first_layer_quant.launches,
        'segment_sum': seg.segment_sum.launches,
        'wall_s': time.perf_counter() - t0,
    }


def scale_init(n_features: int, hidden: Tuple[int, ...]) -> Dict[str, Any]:
    """Both heads as the distributed step's ``init_fn(0, ...)`` draws them."""
    return {
        head: mlp_mod.init_mlp(n_features, hidden, mlp_mod._generator(0, mlp_mod._INIT_STREAM, i))
        for i, head in enumerate(('scores', 'concedes'))
    }


def plain_train_steps(
    batch: Any, hidden: Tuple[int, ...], steps: int, lr: float = 1e-3
) -> List[Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """The distributed step's full-batch steps in one process, with no
    process group: ``fused_pair_logits`` (B1), the masked loss, autograd
    and ``adam_update`` -> ``(loss, parameters)`` after each step."""
    names = VAEP._default_xfns
    modules = {
        h: m.to(batch.device) for h, m in scale_init(train_layout(names, K).n_features, hidden).items()
    }
    flat = [p for h in ('scores', 'concedes') for p in modules[h].parameters()]
    state = mlp_mod.AdamState.zeros(flat)
    ys, yc = VAEP._labels_kernel(batch)
    w = batch.mask.to(torch.float32)

    def bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        y = y.to(torch.float32)
        losses = (
            -y * torch.nn.functional.logsigmoid(logits)
            - (1.0 - y) * torch.nn.functional.logsigmoid(-logits)
        )
        return torch.sum(losses * w) / torch.clamp(w.sum(), min=1.0)

    out = []
    for _ in range(steps):
        ls, lc = fused_ops.fused_pair_logits(
            modules['scores'], modules['concedes'], batch, names=names, k=K
        )
        loss = bce(ls, ys) + bce(lc, yc)
        state, _ = mlp_mod.adam_update(flat, torch.autograd.grad(loss, flat), state, lr)
        out.append((loss.detach(), head_params(modules)))
    return out


def head_params(modules: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'head/Dense_i.weight': tensor, ...}``: copies of both heads' parameters."""
    return {f'{h}/{n}': t.detach().clone() for h, m in modules.items() for n, t in m.state_dict().items()}


def params_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Tuple[float, bool]:
    """``(max |got - want|, within rtol 1e-4 and atol 1e-6 everywhere)``."""
    gap, ok = 0.0, True
    for name, w in want.items():
        g = got[name].to(w.device)
        gap = max(gap, float((g - w).abs().max()))
        ok = ok and bool(torch.allclose(g, w, rtol=1e-4, atol=1e-6))
    return gap, ok


def scale_xt(mesh: Any, draw: Any, device: torch.device) -> Dict[str, Any]:
    """The sharded xT fits of phase 14 on one rank's view of the draw."""
    out = {}
    counts, out['counts_launches'] = counted(
        device, lambda: scale.sharded_xt_counts(draw, mesh, l=16, w=12)
    )
    out['counts'] = {k: v.cpu() for k, v in counts._asdict().items()}
    (grid, it), out['mf_launches'] = counted(
        device, lambda: scale.sharded_xt_fit_matrix_free(draw, mesh, l=192, w=125)
    )
    out['mf'] = (grid.cpu(), int(it))
    return out


def scale_world_one(device: torch.device, card: str, sizes: ScaleSizes) -> Dict[str, Any]:
    """Phase 14 (a): a world of one rank in this process (NCCL on the card,
    gloo on the CPU, a file store in a temporary directory), each entry
    point at full width against the port's single-device path."""
    import torch.distributed as dist

    label = 'scale-out (a), one rank'
    rec: Dict[str, Any] = {'paths': {}}
    paths = rec['paths']
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    # one rank on this host: its bootstrap needs no interface but loopback
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, 'store'), 1), rank=0, world_size=1
        )
        try:
            one = torch.ones(1, device=device)
            dist.all_reduce(one)
            if float(one) != 1.0:
                raise RuntimeError(f'{label}: a {backend} all-reduce over one rank gave {float(one)}')
            mesh = scale.make_mesh(device_type=device.type)
            if tuple(mesh.shape) != (1, 1) or mesh.mesh_dim_names != ('games', 'model'):
                raise RuntimeError(f'{label}: make_mesh() gave {mesh.mesh_dim_names} {tuple(mesh.shape)}')

            # -- xT on phase 5's draw
            draw = synthetic_batch(sizes.xt_games, sizes.actions, seed=2, device=device)
            fields = xt_fields(draw)
            counts = xtops.xt_counts(*fields, l=16, w=12)
            local = scale_xt(mesh, draw, device)
            paths['sharded_xt_counts 16x12'] = local['counts_launches']
            for k, v in counts._asdict().items():
                if not torch.equal(local['counts'][k], v.cpu()):
                    raise RuntimeError(f'{label}: sharded {k} counts differ from xt_counts')
            sol = xtops.solve_xt(xtops.xt_probabilities(counts, l=16, w=12))
            (grid, _, it), paths['sharded_xt_fit 16x12'] = counted(
                device, lambda: scale.sharded_xt_fit(draw, mesh, l=16, w=12)
            )
            checks = {'sharded_xt_fit 16x12': (grid, it, sol.grid, sol.iterations)}
            ref, _ = xtops.solve_xt_matrix_free(*fields, l=192, w=125)
            paths['sharded_xt_fit_matrix_free 192x125'] = local['mf_launches']
            checks['sharded_xt_fit_matrix_free 192x125'] = (*local['mf'], ref.grid, ref.iterations)
            gid = group_ids(draw)
            (grid, it), paths[f'fleet 192x125 x {XT_GROUPS}'] = counted(
                device, lambda: scale.sharded_xt_fit_matrix_free(
                    draw, mesh, l=192, w=125, group_id=gid, n_groups=XT_GROUPS
                ),
            )
            fleet, _ = xtops.solve_xt_matrix_free(*fields, l=192, w=125, group_id=gid, n_groups=XT_GROUPS)
            checks[f'fleet 192x125 x {XT_GROUPS}'] = (grid, it, fleet.grid, fleet.iterations)
            for name, (g, i, want_g, want_i) in checks.items():
                gap = float((g.to(device) - want_g).abs().max())
                its, want_its = _np(torch.as_tensor(i)), _np(want_i)
                if not (gap <= 1e-6 and np.array_equal(its, want_its)):
                    raise RuntimeError(f'{label}: {name}: grid gap {gap} (1e-6), iterations {its} vs {want_its}')
                paths[name].update(grid_gap=gap, iterations=its.tolist())
            mf = paths['sharded_xt_fit_matrix_free 192x125']
            if mf['segment_sum'] != kernel_launches(3 + int(local['mf'][1]), device):
                raise RuntimeError(f"{label}: the sharded 192x125 fit launched B2 {mf['segment_sum']} times")
            rec['xt'] = {'counts': {k: v.cpu() for k, v in counts._asdict().items()},
                         'mf': (ref.grid.cpu(), int(ref.iterations))}
            del draw, fields, gid
            empty_cache(device)

            # -- training at full width, against the same steps with no process group
            batch = synthetic_batch(sizes.games, sizes.actions, seed=3, device=device)
            names = VAEP._default_xfns
            n_features = train_layout(names, K).n_features
            init_fn, step_fn, place = scale.make_train_step(mesh, names, K, sizes.hidden)

            def steps() -> Tuple[List[torch.Tensor], Dict[str, Any]]:
                params, opt = init_fn(0, n_features)
                losses = []
                for _ in range(SCALE_STEPS):
                    params, opt, loss = step_fn(params, opt, place(batch))
                    losses.append(loss)
                return losses, scale_vaep.gather_params(params, mesh, sizes.hidden)

            (losses, whole), paths['make_train_step'] = counted(device, steps)
            plain = plain_train_steps(batch, sizes.hidden, SCALE_STEPS)
            got = head_params(whole)
            for i, (loss, want) in enumerate(plain):
                if not torch.equal(losses[i], loss):
                    raise RuntimeError(f'{label}: step {i + 1} loss {float(losses[i])} != {float(loss)}')
            if not all(torch.equal(got[n], t) for n, t in plain[-1][1].items()):
                raise RuntimeError(f'{label}: the train step parameters differ from the plain steps')
            rec['plain'] = [(float(loss), {n: t.cpu() for n, t in p.items()})
                            for loss, p in plain[:SCALE_RANK_STEPS]]
            paths['make_train_step'].update(losses=[float(x) for x in losses], bitwise=True)
            models, paths['train_distributed'] = counted(
                device, lambda: scale.train_distributed(
                    batch, mesh, names, k=K, hidden=sizes.hidden, epochs=SCALE_STEPS
                ),
            )
            if not all(torch.equal(head_params({h: m.module for h, m in models.items()})[n], t)
                       for n, t in got.items()):
                raise RuntimeError(f'{label}: train_distributed differs from its steps')
            model = VAEP(models=models, device=device)
            want = model.rate_batch(batch)
            (values, _), paths['sharded_rate'] = counted(device, lambda: scale.sharded_rate(model, batch, mesh))
            if not torch.equal(values, want):
                raise RuntimeError(f'{label}: sharded_rate is not bitwise rate_batch')
            del batch, model, want, values, plain, whole
            empty_cache(device)

            # -- the sequence-parallel path and the replica lanes, on phase 4's model
            smodel = make_model(device, sizes.hidden)
            sbatch = synthetic_batch(sizes.games, sizes.actions, seed=0, device=device)
            want = smodel.rate_batch(sbatch)
            seq_mesh = scale.make_sequence_mesh(seq_parallel=1, device_type=device.type)
            got_seq, paths['sequence_rate'] = counted(
                device, lambda: scale.sequence_rate(smodel, sbatch, seq_mesh)
            )
            gap = masked_gap(got_seq, want, sbatch.mask)
            if not gap <= 1e-6:
                raise RuntimeError(f'{label}: sequence_rate {gap} from rate_batch (1e-6)')
            paths['sequence_rate']['max_abs_err'] = gap
            rec['seq_want'] = want.cpu()
            disp = scale.ReplicaDispatcher(smodel, 1)
            lane, paths['rate_replica'] = counted(device, lambda: disp.rate_replica(0, sbatch))
            gang, paths['rate_mesh'] = counted(device, lambda: disp.rate_mesh([sbatch]))
            plain_values = smodel.rate_batch(sbatch, bucket=False).cpu().numpy()
            if not (np.array_equal(lane, plain_values) and np.array_equal(gang[0], plain_values)):
                raise RuntimeError(f'{label}: a replica lane is not bitwise rate_batch')
        finally:
            dist.destroy_process_group()
    for name, line in paths.items():
        print(f'{label}: {name}: {json.dumps(line)} ({card})')
    return rec


def empty_cache(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def scale_rank(out_dir: str, device_type: str, sizes: ScaleSizes) -> None:
    """One of phase 14 (b)'s two ranks (gloo; on the card both sit on
    ``cuda:0``): the sharded xT counts and 192 x 125 fit of the draw, the
    train steps data-parallel (2, 1) and tensor-parallel (1, 2) from the
    distributed step's init, and ``sequence_rate`` over 2 ``seq`` shards;
    its results and launch counts go to ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist

    from socceraction_tpu_torch.utils.env import init_distributed

    rank, _ = init_distributed(backend='gloo', device_type=device_type)
    device = resolve_device(device_type)
    if device.type == 'cuda':
        set_precision()
        # the parent built them: digest-named libraries load without nvcc
        cuda_build.load_libraries(KERNELS)
    out: Dict[str, Any] = {'builds': dict(cuda_build.build_seconds), 'paths': {}}
    mesh = scale.make_mesh(device_type=device_type)
    draw = synthetic_batch(sizes.xt_games, sizes.actions, seed=2, device=device)
    xt = scale_xt(mesh, draw, device)
    out.update(counts=xt['counts'], mf=xt['mf'])
    out['paths']['sharded_xt_counts 16x12'] = xt['counts_launches']
    out['paths']['sharded_xt_fit_matrix_free 192x125'] = xt['mf_launches']
    del draw
    empty_cache(device)

    batch = synthetic_batch(sizes.games, sizes.actions, seed=3, device=device)
    names = VAEP._default_xfns
    n_features = train_layout(names, K).n_features
    for name, mp in (('data-parallel (2, 1)', 1), ('tensor-parallel (1, 2)', 2)):
        m = mesh if mp == 1 else scale.make_mesh(model_parallel=2, device_type=device_type)
        init_fn, step_fn, place = scale.make_train_step(m, names, K, sizes.hidden)

        def steps() -> Tuple[List[float], Dict[str, torch.Tensor]]:
            params, opt = init_fn(0, n_features)
            local = place(batch)
            losses = []
            for _ in range(SCALE_RANK_STEPS):
                params, opt, loss = step_fn(params, opt, local)
                losses.append(float(loss))
            return losses, head_params(scale_vaep.gather_params(params, m, sizes.hidden))

        (losses, params), out['paths'][f'train steps {name}'] = counted(device, steps)
        out[name] = (losses, {n: t.cpu() for n, t in params.items()})
    del batch
    empty_cache(device)

    seq_mesh = scale.make_sequence_mesh(seq_parallel=2, device_type=device_type)
    smodel = make_model(device, sizes.hidden)
    sbatch = synthetic_batch(sizes.games, sizes.actions, seed=0, device=device)
    values, out['paths']['sequence_rate seq=2'] = counted(
        device, lambda: scale.sequence_rate(smodel, sbatch, seq_mesh)
    )
    out['seq'] = (seq_mesh.get_local_rank('seq'), values.cpu())
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def scale_two_ranks(
    device: torch.device, card: str, sizes: ScaleSizes, world_one: Dict[str, Any], timeout_s: float,
) -> Dict[str, Any]:
    """Phase 14 (b): two gloo ranks on the one device, spawned through the
    port's launcher, held to (a): counts bitwise, the 192 x 125 grid within
    1e-6 with equal iterations on both ranks and to (a), the train steps'
    losses at rtol 1e-5 and parameters at rtol 1e-4, atol 1e-6 of the
    plain steps and bitwise across the ranks, ``sequence_rate`` within 1e-6
    of ``rate_batch``. Returns the launches by path, summed over ranks."""
    from socceraction_tpu_torch.utils.env import run_distributed_workers

    label = 'scale-out (b), two ranks on one card' if device.type == 'cuda' else 'scale-out (b), two CPU ranks'
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    os.makedirs(SCALE_DIR)
    try:
        t0 = time.perf_counter()
        run_distributed_workers(
            os.path.abspath(__file__), 2,
            args=('--scale-rank', SCALE_DIR, device.type, json.dumps(sizes._asdict())),
            timeout_s=timeout_s,
            # CPU ranks share the host's cores: one thread each
            env={'OMP_NUM_THREADS': '1'} if device.type == 'cpu' else None,
        )
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(SCALE_DIR, f'rank{r}.pt'), weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(SCALE_DIR, ignore_errors=True)

    want = world_one['xt']
    for r, res in enumerate(ranks):
        for k, v in want['counts'].items():
            if not torch.equal(res['counts'][k], v):
                raise RuntimeError(f'{label}: rank {r} {k} counts differ from one rank')
        grid, it = res['mf']
        gap = float((grid - want['mf'][0]).abs().max())
        if not (gap <= 1e-6 and it == want['mf'][1]):
            raise RuntimeError(f"{label}: rank {r} 192x125 grid gap {gap}, iterations {it} vs {want['mf'][1]}")
        res['paths']['sharded_xt_fit_matrix_free 192x125'].update(grid_gap=gap, iterations=it)
    summary: Dict[str, Any] = {}
    for name in ('data-parallel (2, 1)', 'tensor-parallel (1, 2)'):
        (l0, p0), (l1, p1) = ranks[0][name], ranks[1][name]
        if l0 != l1 or not all(torch.equal(p0[n], p1[n]) for n in p0):
            raise RuntimeError(f'{label}: {name}: the ranks hold different losses or parameters')
        plain_losses = [loss for loss, _ in world_one['plain']]
        loss_ok = np.allclose(l0, plain_losses, rtol=1e-5, atol=0)
        gap, params_ok = params_gap(p0, world_one['plain'][-1][1])
        if not (loss_ok and params_ok):
            raise RuntimeError(f'{label}: {name}: losses {l0} vs {plain_losses}, parameter gap {gap}')
        summary[name] = {'losses': l0, 'plain_losses': plain_losses, 'max_param_gap': gap}
    blocks = sorted((res['seq'] for res in ranks), key=lambda s: s[0])
    values = torch.cat([b for _, b in blocks], dim=1)
    mask = synthetic_batch(sizes.games, sizes.actions, seed=0, device='cpu').mask
    gap = masked_gap(values, world_one['seq_want'], mask)
    if not gap <= 1e-6:
        raise RuntimeError(f'{label}: sequence_rate at seq=2 {gap} from rate_batch (1e-6)')
    summary['sequence_rate seq=2'] = {'max_abs_err': gap}
    launches: Dict[str, Dict[str, int]] = {}
    for r, res in enumerate(ranks):
        for name, line in res['paths'].items():
            print(f'{label}: rank {r}: {name}: {json.dumps(line)} ({card})')
            tot = launches.setdefault(name, {'gather_matmul': 0, 'segment_sum': 0})
            for kernel in tot:
                tot[kernel] += line[kernel]
    print(f"{label}: builds in the ranks (0.0: loaded, not compiled): "
          f"{json.dumps([res['builds'] for res in ranks])}")
    print(f'{label}: held to one rank: {json.dumps(summary)}; both ranks in {spawn_s:.1f} s ({card})')
    return launches


def scale_phase(
    device: torch.device, card: str = 'CPU', sizes: ScaleSizes = ScaleSizes(),
    rank_timeout_s: float = SCALE_RANK_TIMEOUT_S,
) -> Dict[str, Any]:
    """Phase 14: the scale-out layer, (a) in a world of one rank, then (b)
    over two ranks on the same device, which must end within
    ``rank_timeout_s``. Returns every path's launches."""
    t0 = time.perf_counter()
    one = scale_world_one(device, card, sizes)
    t1 = time.perf_counter()
    two = scale_two_ranks(device, card, sizes, one, rank_timeout_s)
    print(f'scale-out: phase 14 in {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} s, '
          f'(b) {time.perf_counter() - t1:.1f} s)')
    return {
        'one': {name: {k: line[k] for k in ('gather_matmul', 'segment_sum')}
                for name, line in one['paths'].items()},
        'two': two,
    }


def scale_paths(launches: Dict[str, Any], kernel: str) -> Dict[str, int]:
    """Phase 14's paths that launch ``kernel``, labelled for the kernels
    line; raises if one of them launched it no time."""
    out = {}
    for part, label in (('one', 'phase 14 (a) one rank'), ('two', 'phase 14 (b) two ranks')):
        for name, counts in launches[part].items():
            if counts[kernel]:
                out[f'{label}: {name}'] = counts[kernel]
    expected = {
        'gather_matmul': ('make_train_step', 'train_distributed', 'sharded_rate', 'sequence_rate',
                          'rate_replica', 'rate_mesh', 'train steps data-parallel (2, 1)',
                          'train steps tensor-parallel (1, 2)', 'sequence_rate seq=2'),
        'segment_sum': ('sharded_xt_fit 16x12', 'sharded_xt_fit_matrix_free 192x125',
                        f'fleet 192x125 x {XT_GROUPS}', 'sharded_xt_counts 16x12'),
    }[kernel]
    seen = {name.split(': ', 1)[1] for name in out}
    missing = [name for name in expected if name not in seen]
    if missing:
        raise RuntimeError(f'phase 14 paths launched {kernel} no time: {missing}')
    return out


# -- the cross-process telemetry plane (phase 15) --------------------------------------

#: Where phase 15 writes the model, phase 4's values, the replicas' sockets,
#: run logs and reports (git-ignored, removed at the end). The sockets are
#: bound by this relative path: an AF_UNIX path holds at most 107 bytes,
#: and a checkout's absolute path has no such limit.
FLEET_DIR = os.path.join('build', 'fleet')
#: Seconds the replica processes may take from their spawn to serving
#: their endpoints; every replica is killed when one fails or this passes.
FLEET_TIMEOUT_S = 240.0
#: The latency objective each replica scores its requests against and the
#: aggregator evaluates mesh-wide. A request of 512 whole games takes tens
#: of milliseconds on a shared card: only a fault, not contention, should
#: read as a bad event, since the phase holds the event counts exactly.
FLEET_LATENCY_MS = 1000.0
#: The aggregator's divergence threshold. Each replica's parity error is a
#: few f32 ulps of the values, so two replicas can sit 2 to 4 times apart
#: by rounding alone; a replica degraded by a fault sits orders away.
FLEET_SICK_FACTOR = 50.0


#: The bare ``rate_batch`` calls each replica times while every replica
#: rates (the shared-card wall).
FLEET_BARE_CALLS = 4


class FleetSizes(NamedTuple):
    """Phase 15's shapes: replica processes, each one's batch and its
    one-game requests through its service."""

    replicas: int = 4
    games: int = GAMES
    actions: int = ACTIONS
    requests: int = 8


def fleet_slo() -> SLOConfig:
    return SLOConfig.simple(latency_ms=FLEET_LATENCY_MS)


def game_request(host: ActionBatch, k: int) -> ServeRequest:
    """Game ``k`` of a host batch as a one-game request at the batch's
    width (:func:`one_game_request`)."""
    fields = {name: t[k : k + 1].numpy().copy() for name, t in host.fields().items()}
    fields['game_id'] = np.zeros(1, dtype=np.int32)
    return one_game_request(fields, int(host.n_actions[k]))


def wait_for(paths: List[str], deadline: float, what: str) -> None:
    """Poll until every path exists; raise once ``deadline`` (monotonic) passes."""
    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > deadline:
            missing = [p for p in paths if not os.path.exists(p)]
            raise RuntimeError(f'timed out waiting for {what}: {missing}')
        time.sleep(0.005)


def write_json(path: str, obj: Any) -> None:
    """``obj`` as JSON at ``path``, whole or not at all (a reader polls for it)."""
    with open(path + '.tmp', 'w', encoding='utf-8') as fh:
        json.dump(obj, fh)
    os.replace(path + '.tmp', path)


def fleet_replica(fleet_dir: str, index: int, device_type: str) -> None:
    """One of phase 15's replica processes, spawned by :func:`fleet_phase`.

    Activates the model the parent published in a :class:`ModelRegistry`
    (on the card with the parent's built kernels: no ``nvcc``) and serves
    it through a :class:`RatingService` at phase 16's shape with
    ``slo=fleet_slo()`` and a :class:`ParityProbe` on every flush, under a
    run log. It warms the service's ladder and rates its batch once, waits
    for every replica to be warm, times its bare synced ``rate_batch`` of
    the batch while the others rate theirs, then sends its first
    ``requests`` games one at a time through the service (entering at
    ``_submit``), replica 0's first under the parent's context. Each
    request is held to its own one-game reference; replica 0's bare
    ``rate_batch`` (phase 4's batch and bucket) bitwise to phase 4's
    values. It writes its report, then serves ``service.telemetry()``
    until its standard input closes.
    """
    # with no card this raises: a replica never rates on the CPU in its place
    device = resolve_device(device_type)
    if device.type == 'cuda':
        set_precision()
        cuda_build.load_libraries(KERNELS)
    with open(os.path.join(fleet_dir, 'spec.json'), encoding='utf-8') as fh:
        spec = json.load(fh)
    replica = f'replica-{index}'
    deadline = time.monotonic() + spec['timeout_s']
    registry = ModelRegistry(spec['registry'], device=device)
    # activation is per-process state: the registry directory is shared
    registry.activate('vaep', '1')
    model = registry.active()[2]
    batch = synthetic_batch(spec['games'], spec['actions'], seed=spec['seeds'][index], device=device)
    host = batch.to('cpu')
    reqs = [game_request(host, k) for k in range(spec['requests'])]
    want = torch.load(spec['values'], weights_only=True) if index == 0 else None
    n_requests = spec['requests']
    probe = ParityProbe(sample_rate=1.0, max_abs_err=1e-5, queue_size=n_requests + 1)
    gm.fused_first_layer_quant.launches = 0
    walls, bare = [], []
    with RunLog(os.path.join(fleet_dir, replica, 'obs.jsonl'), config={'phase': 15, 'replica': replica}):
        shape = ServeSizes()  # phase 16's service shape at this batch's width
        svc = RatingService(registry=registry, slo=fleet_slo(), parity=probe, max_actions=spec['actions'],
                            max_batch_size=shape.max_batch_size, max_wait_ms=shape.max_wait_ms,
                            max_queue=shape.max_queue)
        takes = count_takes(svc)
        svc.warmup()
        model.rate_batch(batch)
        sync(device)
        first_rated_unix = time.time()
        # the bare calls overlap only once every replica is warm
        write_json(os.path.join(fleet_dir, f'warm-{index}'), {})
        wait_for([os.path.join(fleet_dir, f'warm-{i}') for i in range(spec['replicas'])],
                 deadline, 'every replica to be warm')
        for _ in range(FLEET_BARE_CALLS):
            sync(device)
            t0 = time.perf_counter()
            values = model.rate_batch(batch)
            sync(device)
            bare.append(time.perf_counter() - t0)
        bitwise = torch.equal(values.cpu(), want) if want is not None else None
        del values
        results = []
        for k, req in enumerate(reqs):
            ctx = (RequestContext.from_wire(spec['headers']) if index == 0 and k == 0
                   else new_request_context('rate'))
            t0 = time.perf_counter()
            fut = svc._submit(serve_service._Payload(req.staging, req.gs, keep=(0, req.n), ctx=ctx),
                              'rate', ctx)
            results.append(fut.result(timeout=300))
            walls.append(time.perf_counter() - t0)
        if not probe.flush(timeout=300):
            raise RuntimeError(f'{replica}: the parity probe did not finish')
    # each request against its references: one more rate_batch a request
    gaps = request_gaps(model, reqs, results, device, replica)
    launches = gm.fused_first_layer_quant.launches
    parity = probe.stats()
    if not (parity['probes'] == n_requests and parity['max_abs_err'] <= 1e-5):
        raise RuntimeError(f'{replica}: parity probe {parity}')
    if want is not None and not bitwise:
        raise RuntimeError(f'{replica}: the bare rate_batch differs from phase 4')
    if takes != [(1, 1)] * n_requests:
        raise RuntimeError(f'{replica}: the requests went out in takes {takes}')
    phase4_gap = None
    if want is not None:
        phase4_gap = max(float(np.abs(got - want[k, : req.n].numpy()).max())
                         for k, (req, got) in enumerate(zip(reqs, results)))
    calls = len(svc.ladder) + 1 + FLEET_BARE_CALLS + 2 * n_requests
    report = {
        'replica': replica,
        # rate_batch calls: the ladder's warm-up, the warm call, the bare
        # calls, one flush a request and one full-window rate_batch a
        # request to hold it to
        'calls': calls,
        'rated_actions': (1 + FLEET_BARE_CALLS) * batch.total_actions + 2 * sum(r.n for r in reqs),
        'requests': n_requests,
        'first_rated_unix': first_rated_unix,
        'request_walls_s': walls,
        'median_rate_batch_s': float(np.median(bare)),
        'launches': launches,
        'parity_max_abs_err': parity['max_abs_err'],
        **gaps,
        # replica 0 only: its batch is phase 4's
        'bitwise_phase4': bitwise,
        'max_abs_err_requests_vs_phase4': phase4_gap,
        'memory_allocated': torch.cuda.memory_allocated(device) if device.type == 'cuda' else None,
        'max_memory_allocated': torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else None,
    }
    # the report is in place before the endpoint answers: the parent reads
    # it once /health answers
    write_json(os.path.join(fleet_dir, f'{replica}.json'), report)
    print(f'fleet {replica}: {json.dumps(report)}', flush=True)
    try:
        with serve_telemetry(telemetry=svc.telemetry(replica=replica), unix_path=spec['sockets'][index]):
            sys.stdin.read()
    finally:
        svc.close()


def fleet_tail(path: str, n: int = 3000) -> str:
    with open(path, encoding='utf-8', errors='replace') as fh:
        return fh.read()[-n:]


def series_total(metrics: Dict[str, Any], name: str, **labels: str) -> float:
    """The sum of ``total`` over a snapshot dict's series of ``name``
    whose labels include ``labels``."""
    return sum(
        float(s.get('total') or 0.0)
        for s in (metrics.get(name) or {}).get('series', ())
        if all((s.get('labels') or {}).get(k) == v for k, v in labels.items())
    )


def series_count(metrics: Dict[str, Any], name: str) -> int:
    return sum(int(s.get('count') or 0) for s in (metrics.get(name) or {}).get('series', ()))


def request_events(path: str, request_id: str) -> List[Dict[str, Any]]:
    """The run log's events of one request: its enqueue and done, and the
    ``serve/flush`` span that lists it."""
    out = []
    with open(path, encoding='utf-8') as fh:
        for line in fh:
            event = json.loads(line)
            if event.get('request_id') == request_id or (
                event.get('event') == 'span_close' and event.get('name') == 'serve/flush'
                and request_id in (event.get('attrs') or {}).get('request_ids', ())
            ):
                out.append(event)
    return out


def check_fleet_merge(
    snap: Any, docs: Dict[str, Dict[str, Any]], reports: Dict[str, Dict[str, Any]], sizes: FleetSizes,
) -> Dict[str, Any]:
    """The merged counters against the replicas' own documents and reports,
    exactly: the services' requests, rated actions, ``rate_batch`` calls
    (the warm-ups included) and the SLO's events of each objective. Raises
    on any difference."""
    merged = snap.metrics
    served = series_total(merged, 'serve/requests', kind='rate')
    per_doc = sum(series_total(d['metrics'], 'serve/requests', kind='rate') for d in docs.values())
    if not served == per_doc == sizes.replicas * sizes.requests == sum(r['requests'] for r in reports.values()):
        raise RuntimeError(f'merged serve/requests {served}, documents {per_doc}')
    rated = series_total(merged, 'vaep/rated_actions')
    per_doc = sum(series_total(d['metrics'], 'vaep/rated_actions') for d in docs.values())
    reported = sum(r['rated_actions'] for r in reports.values())
    if not rated == per_doc == reported:
        raise RuntimeError(f'merged vaep/rated_actions {rated}, documents {per_doc}, reported {reported}')
    calls = series_count(merged, 'vaep/rate_batch_seconds')
    want_calls = sum(r['calls'] for r in reports.values())
    if calls != want_calls:
        raise RuntimeError(f'merged vaep/rate_batch_seconds count {calls}, want {want_calls}')
    events = {}
    for objective in (o.name for o in fleet_slo().objectives):
        got = series_total(merged, 'slo/events', objective=objective)
        own = sum(series_total(d['metrics'], 'slo/events', objective=objective) for d in docs.values())
        if not got == own == sizes.replicas * sizes.requests:
            raise RuntimeError(f'merged slo/events{{objective={objective}}} {got}, replicas {own}')
        events[objective] = got
    return {'serve_requests': served, 'rated_actions': rated, 'rate_batch_calls': calls, 'slo_events': events}


def fleet_phase(
    model: VAEP, values: torch.Tensor, device: torch.device, card: str = 'CPU',
    sizes: FleetSizes = FleetSizes(), phase4_median_s: Optional[float] = None,
    timeout_s: float = FLEET_TIMEOUT_S,
) -> Dict[str, int]:
    """Phase 15: ``sizes.replicas`` replica processes share ``device``, each
    serving its own requests through a :class:`RatingService`
    (:func:`fleet_replica`) and exposing the service's telemetry; one
    :class:`FleetAggregator` here scrapes and merges them.

    The parent publishes ``model`` in a :class:`ModelRegistry` (through the
    checkpoint codec) and saves ``values`` (phase 4's, on the seed-0 batch)
    for the replicas, mints a request context that replica 0's service
    serves one hop away, and spawns the replicas
    (fresh interpreters: this process holds the card). It waits for every
    endpoint to answer ``/health``, then holds the merge to the replicas'
    own counts (:func:`check_fleet_merge`), the SLO mesh-wide, a divergence
    row per replica and signal, and the two run logs to one request id one
    hop apart; then it SIGKILLs the last replica and holds the next pass
    to exactly that replica stale, the status degraded and the sums
    unchanged. Returns each replica's B1 launches."""
    label = f'fleet ({sizes.replicas} replica processes on {device}, {card})'
    fleet_dir = os.path.abspath(FLEET_DIR)
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    os.makedirs(FLEET_DIR, mode=0o700)
    ids = [f'replica-{i}' for i in range(sizes.replicas)]
    sockets = [os.path.join(FLEET_DIR, f'{rid}.sock') for rid in ids]
    addresses = dict(zip(ids, sockets))
    ModelRegistry(os.path.join(fleet_dir, 'registry'), device=device).publish('vaep', '1', model)
    torch.save(values.cpu(), os.path.join(fleet_dir, 'phase4_values.pt'))
    t_phase = time.perf_counter()
    procs: Dict[str, subprocess.Popen] = {}
    logs = {rid: os.path.join(fleet_dir, f'{rid}.log') for rid in ids}
    try:
        with RunLog(os.path.join(fleet_dir, 'front', 'obs.jsonl'), config={'phase': 15, 'role': 'front'}):
            ctx = new_request_context('rate')
            record_request_enqueue(ctx, queue_depth=0)
            write_json(os.path.join(fleet_dir, 'spec.json'), {
                'registry': os.path.join(fleet_dir, 'registry'),
                'values': os.path.join(fleet_dir, 'phase4_values.pt'),
                # replica 0 draws phase 4's batch
                'seeds': list(range(sizes.replicas)),
                'games': sizes.games, 'actions': sizes.actions,
                'requests': sizes.requests, 'replicas': sizes.replicas,
                'sockets': sockets, 'headers': ctx.to_wire(), 'timeout_s': timeout_s,
            })
            env = dict(os.environ)
            if device.type == 'cpu':
                env['OMP_NUM_THREADS'] = '1'  # CPU replicas share the host's cores
            spawned = {}
            for i, rid in enumerate(ids):
                with open(logs[rid], 'w') as log:
                    spawned[rid] = time.time()
                    procs[rid] = subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), '--fleet-replica', fleet_dir,
                         str(i), device.type],
                        stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT, env=env,
                    )
            # ready: each endpoint answers /health, within the group's limit
            deadline = time.monotonic() + timeout_s
            pending = set(ids)
            while pending:
                for rid in sorted(pending):
                    if procs[rid].poll() is not None:
                        raise RuntimeError(
                            f'{label}: {rid} exited {procs[rid].returncode}:\n{fleet_tail(logs[rid])}')
                    try:
                        health = scrape_health(addresses[rid], timeout=1.0)
                    except EndpointError:
                        continue
                    if health.get('replica') != rid:
                        raise RuntimeError(f'{label}: {rid} answered as {health}')
                    pending.discard(rid)
                if pending and time.monotonic() > deadline:
                    raise RuntimeError(f'{label}: no /health from {sorted(pending)} in {timeout_s} s')
                time.sleep(0.02)
            ready_s = time.perf_counter() - t_phase
            reports = {}
            for rid in ids:
                with open(os.path.join(fleet_dir, f'{rid}.json'), encoding='utf-8') as fh:
                    reports[rid] = json.load(fh)
            record_request_done(ctx, 'ok', time.perf_counter() - ctx.enqueue_t)

        aggregator = FleetAggregator(
            addresses, stale_after_s=timeout_s, sick_factor=FLEET_SICK_FACTOR,
            slo=fleet_slo(), registry=MetricRegistry(),
        )
        t0 = time.perf_counter()
        outcomes = aggregator.scrape()
        scrape_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        snap = aggregator.aggregate()
        aggregate_s = time.perf_counter() - t0
        if not all(outcomes.values()) or snap.status != 'ok' or snap.stale_replicas:
            raise RuntimeError(f'{label}: scrape {outcomes}, status {snap.status}, stale '
                               f'{snap.stale_replicas}, divergence {snap.divergence}')
        docs = {rid: aggregator.last_wire(rid) for rid in ids}
        merge = check_fleet_merge(snap, docs, reports, sizes)
        rows = {(r['replica'], r['signal']) for r in snap.divergence}
        # the services' own rows: parity, errors, p99 and breaker state
        want_rows = {(rid, s) for rid in ids
                     for s in ('parity_max_abs_err', 'error_rate', 'request_p99_s', 'breaker_state')}
        if not want_rows <= rows:
            raise RuntimeError(f'{label}: divergence rows {sorted(rows)}')
        if snap.slo is None or any(o.get('breaching') for o in snap.slo['objectives'].values()):
            raise RuntimeError(f'{label}: mesh-wide SLO {snap.slo}')
        t0 = time.perf_counter()
        doc_bytes = len(fetch(sockets[0], '/snapshot'))
        doc_s = time.perf_counter() - t0

        # one hop: the parent's enqueue and done, replica 0's under the same id
        front = request_events(os.path.join(fleet_dir, 'front', 'obs.jsonl'), ctx.request_id)
        hop = request_events(os.path.join(fleet_dir, ids[0], 'obs.jsonl'), ctx.request_id)
        if (sorted(e['event'] for e in front) != ['request_done', 'request_enqueue']
                or any(e.get('hop') for e in front)):
            raise RuntimeError(f'{label}: the front run log holds {front}')
        if (sorted(e['event'] for e in hop) != ['request_done', 'request_enqueue', 'span_close']
                or any(e.get('hop') != 1 for e in hop if e['event'] != 'span_close')
                or set(next(e for e in hop if e['event'] == 'request_done')['segments'])
                != {'queue_wait', 'pad', 'dispatch', 'slice'}
                or next(e for e in hop if e['event'] == 'span_close')['attrs']['request_ids'] != [ctx.request_id]):
            raise RuntimeError(f'{label}: replica 0 run log holds {hop}')

        # SIGKILL the last replica: loud staleness, its counters kept
        victim = ids[-1]
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)
        outcomes = aggregator.scrape()
        after = aggregator.aggregate()
        if outcomes[victim] or after.stale_replicas != (victim,) or after.status != 'degraded':
            raise RuntimeError(f'{label}: after the kill: scrape {outcomes}, stale '
                               f'{after.stale_replicas}, status {after.status}')
        if check_fleet_merge(after, docs, reports, sizes) != merge:
            raise RuntimeError(f'{label}: the merged sums moved after {victim} died')
    finally:
        # a replica serves until its standard input closes
        for proc in procs.values():
            proc.stdin.close()
        for rid, proc in procs.items():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    for rid, proc in procs.items():
        if rid != victim and proc.returncode != 0:
            raise RuntimeError(f'{label}: {rid} exited {proc.returncode}:\n{fleet_tail(logs[rid])}')
    shutil.rmtree(FLEET_DIR, ignore_errors=True)

    launches = {}
    for rid in ids:
        rep = reports[rid]
        # the ladder's warm-up, the warm call, the bare calls, one a request
        want = kernel_launches(rep['calls'], device)
        if rep['launches'] != want:
            raise RuntimeError(f"{label}: {rid} launched gather_matmul {rep['launches']} times, not {want}")
        launches[rid] = rep['launches']
        line = {k: rep[k] for k in ('calls', 'rated_actions', 'requests', 'request_walls_s',
                                    'median_rate_batch_s', 'launches', 'parity_max_abs_err',
                                    'max_abs_err_vs_reference', 'max_abs_err_vs_full_window_rate_batch',
                                    'bitwise_phase4', 'max_abs_err_requests_vs_phase4', 'memory_allocated',
                                    'max_memory_allocated')}
        line['start_to_first_rated_batch_s'] = rep['first_rated_unix'] - spawned[rid]
        print(f'{label}: {rid}: {json.dumps(line)}')
    print(f'{label}: rate_batch median while {sizes.replicas} share the device: '
          f"{json.dumps({rid: reports[rid]['median_rate_batch_s'] for rid in ids})}; phase 4 alone: "
          f'{phase4_median_s}')
    print(f'{label}: merged, exact: {json.dumps(merge)}; divergence: '
          f'{json.dumps(list(snap.divergence))}')
    print(f'{label}: one scrape of {sizes.replicas} endpoints {scrape_s:.6f} s, aggregate '
          f'{aggregate_s:.6f} s, one wire document {doc_s:.6f} s ({doc_bytes} bytes); after the '
          f'SIGKILL of {victim}: stale {list(after.stale_replicas)}, status {after.status}; '
          f'request {ctx.request_id} one hop; B1 launches {json.dumps(launches)}; ready in '
          f'{ready_s:.1f} s, phase 15 in {time.perf_counter() - t_phase:.1f} s')
    return launches


# -- phase 16: in-process serving ----------------------------------------------------------

SERVE_DIR = os.path.join('build', 'serve')
#: The drill's injected clock: the breaker's dwell before its probe.
SERVE_RECOVERY_S = 10.0
#: Request values against each reference (one-game ``rate_batch`` and
#: ``rate_batch_reference``), and the gap that tells two versions apart.
SERVE_ATOL = 1e-5
SERVE_APART = 1e-3
#: The parity probe's band under the service's flushes (f32; PR 8's band).
SERVE_PROBE_BAND = 2.4e-7
#: The fleet's code of each breaker state (``resil/breaker_state``).
BREAKER_CODES = {'closed': 0.0, 'half_open': 1.0, 'open': 2.0}


class ServeSizes(NamedTuple):
    """Phase 16's shapes: the JAX service's defaults (window, ladder top,
    wait, queue), the traffic (clients x requests, each one game of
    ``low`` to ``max_actions`` actions) and the swap's clients."""

    max_actions: int = ACTIONS
    max_batch_size: int = 64
    max_wait_ms: float = 2.0
    max_queue: int = 256
    clients: int = 16
    requests: int = 32
    low: int = 1200
    swap_clients: int = 4
    swap_requests: int = 16
    drain_requests: int = 5
    hidden: Tuple[int, ...] = HIDDEN
    #: the end-location grid (P = 96: bucket 128, 212,992 rows at 1664),
    #: the sweep's types (all 23) and the custom grid's perturbations
    grid: Tuple[int, int] = (12, 8)
    sweep_types: int = 23
    custom_p: int = 16
    probe_clients: int = 4
    probe_requests: int = 16
    telemetry_requests: int = 4


class ServeRequest(NamedTuple):
    """One request built from arrays: its host staging batch (numpy
    fields, as ``pack_actions(..., as_numpy=True)`` returns them), its
    goalscore block and its action count."""

    staging: ActionBatch
    gs: np.ndarray
    n: int


def serve_request(rng: np.random.Generator, n: int, max_actions: int) -> ServeRequest:
    """A one-game request of ``n`` actions drawn as ``synthetic_batch``
    draws its columns, padded to ``max_actions`` as the packer pads, with
    the whole-match goalscore block the service computes for a frame."""
    cols = _draw_spadl_columns(rng, 1, n, np.float32, np.int32)
    fields = {}
    for name, a in cols.items():
        full = np.zeros((1, max_actions), dtype=a.dtype)
        full[:, :n] = a
        fields[name] = full
    valid = np.arange(max_actions)[None, :] < n
    fields['mask'] = valid
    fields['n_actions'] = np.array([n], dtype=np.int32)
    fields['game_id'] = np.zeros(1, dtype=np.int32)
    fields['row_index'] = np.where(valid, np.arange(max_actions, dtype=np.int32), -1).astype(np.int32)
    return one_game_request(fields, n)


def one_game_request(fields: Dict[str, np.ndarray], n: int) -> ServeRequest:
    """A request of one game's padded host fields and its ``n`` valid
    actions, with the whole-match goalscore block the service computes for
    a frame."""
    is_home = fields['is_home'][0, :n]
    team, opp, _a, _b = score_prefix(
        fields['type_id'][0, :n].astype(np.int64), fields['result_id'][0, :n].astype(np.int64),
        is_home == bool(is_home[0]),
    )
    return ServeRequest(ActionBatch(**fields), goalscore_block(team, opp, fields['type_id'].shape[1]), n)


def submit_request(svc: RatingService, req: ServeRequest, admit: bool = False) -> Any:
    """``req`` into the service where ``rate`` arrives once it has packed
    its frame (``_submit``): admission, the batcher, coalescing, padding,
    the breaker, B1, the guards and the slicing are the service's own.
    ``admit`` first asks SLO admission, as ``rate`` does before packing."""
    if admit:
        svc._check_admission('rate')
    ctx = new_request_context('rate')
    return svc._submit(serve_service._Payload(req.staging, req.gs, keep=(0, req.n), ctx=ctx),
                       'rate', ctx)


def submit_scenario(svc: RatingService, req: ServeRequest, grid: ScenarioGrid) -> Any:
    """``grid`` over ``req``'s game where ``rate_scenarios`` arrives once it
    has packed its frame: SLO admission, the grid's checks against the
    window and the model, then ``_submit`` of a scenario payload."""
    svc._check_admission('scenario')
    svc._validate_grid(grid)
    ctx = new_request_context('scenario')
    return svc._submit(serve_service._ScenarioPayload(req.staging, req.gs, grid, None, ctx),
                       'scenario', ctx)


def run_clients(
    svc: RatingService, reqs: List[ServeRequest], clients: int, admit: bool = False,
) -> List[Any]:
    """``reqs`` from ``clients`` closed-loop client threads (each its own
    contiguous share); returns the results in request order."""
    per = len(reqs) // clients
    results: List[Any] = [None] * len(reqs)
    errors: List[BaseException] = []

    def client(c: int) -> None:
        try:
            for i in range(c * per, (c + 1) * per):
                results[i] = submit_request(svc, reqs[i], admit).result(timeout=300)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f'a client failed: {errors[0]!r}')
    return results


def metric_total(name: str) -> float:
    """The total of every series of one metric in the process registry."""
    inst = REGISTRY.snapshot().get(name)
    return float(sum(s.total for s in inst.series)) if inst is not None else 0.0


def scenario_counts() -> Dict[str, float]:
    return {'dispatches': metric_total('scenario/dispatches'),
            'fallbacks': metric_total('scenario/fallbacks'),
            'fallback_flushes': REGISTRY.snapshot().value('serve/fallback_flushes')}


def fold_first_layer(model: VAEP, batch: Any, overrides: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """B1 on the operands a scenario fold's ``rate_batch`` gives it, against
    its plain version (atol 1e-4, rtol 1e-5, as phase 3), timed, with its
    bound."""
    with captured(fused_ops, 'fused_first_layer_quant') as calls:
        model.rate_batch(batch, dense_overrides=overrides, bucket=False)
    ops = calls[0][0]
    got = gm.fused_first_layer_quant(*ops)
    want = gm.fused_first_layer_reference(*ops)
    sync(got.device)
    max_abs = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    tables, _, _, ids, x = ops
    record = {
        'shape': {'n': ids.shape[0], 'k': ids.shape[1], 'r': tables.shape[1], 'h': tables.shape[2],
                  'd': x.shape[1], 'dtype': str(tables.dtype).replace('torch.', '')},
        'max_abs_err': max_abs,
        'ms': graph_ms(lambda: gm.fused_first_layer_quant(*ops), reps=10),
        'plain_ms': time_ms(lambda: gm.fused_first_layer_reference(*ops), reps=5),
        **first_layer_bound(ops),
    }
    del got, want, calls
    return record


def request_references(model: VAEP, req: ServeRequest, device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """``rate_batch_reference`` and ``rate_batch`` of the request's own
    one-game batch on ``device`` (values of its ``n`` actions)."""
    batch, overrides = serve_service._upload(req.staging, req.gs, device)
    ref = model.rate_batch_reference(batch, dense_overrides=overrides)[0, : req.n].cpu().numpy()
    fused = model.rate_batch(batch, dense_overrides=overrides)[0, : req.n].cpu().numpy()
    return ref, fused


def series_quantiles(name: str, **labels: str) -> Dict[str, Any]:
    """The process registry's quantile estimates of one histogram series."""
    s = REGISTRY.snapshot().series(name, **labels)
    return dict(s.quantiles or {}) if s is not None else {}


def serve_counts() -> Dict[str, float]:
    snap = REGISTRY.snapshot()
    out = {f'flushes_{r}': snap.value('serve/flushes', reason=r) for r in ('full', 'deadline', 'close')}
    out['fallback_flushes'] = snap.value('serve/fallback_flushes')
    out['swaps'] = snap.value('serve/model_swaps')
    out['rollbacks'] = snap.value('serve/model_swaps', reason='rollback')
    return out


def segment_means(before: Any, after: Any) -> Dict[str, float]:
    """Mean seconds of each ``serve/segment_seconds`` segment between two
    registry snapshots: the queue wait a request, pad, dispatch (the copy
    to the card, ``rate_batch`` and the values' copy back) and slice a
    flush."""
    out = {}
    for seg_name in ('queue_wait', 'pad', 'dispatch', 'slice'):
        a = after.series('serve/segment_seconds', segment=seg_name)
        b = before.series('serve/segment_seconds', segment=seg_name)
        n = (a.count if a else 0) - (b.count if b else 0)
        if n:
            out[seg_name] = ((a.total if a else 0.0) - (b.total if b else 0.0)) / n
    return out


def delta(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
    return {k: after[k] - before[k] for k in after}


def count_takes(svc: RatingService) -> List[Tuple[int, int]]:
    """Record ``(requests, bucket)`` of every flush the service's batcher
    runs from now on; returns the list it appends to."""
    takes: List[Tuple[int, int]] = []
    real = svc._batcher._runner

    def runner(payloads: List[Any], bucket: int, *, lane: int = 0) -> List[Any]:
        takes.append((len(payloads), bucket))
        return real(payloads, bucket, lane=lane)

    svc._batcher._runner = runner
    return takes


def read_events(prof: Any) -> Dict[str, Any]:
    """Host reads and stream waits in a profiled flush, each against the
    start of the values' copy (the ``serve/values_copy`` range)."""
    from torch.autograd import DeviceType

    reads = ('aten::_local_scalar_dense', 'cudaStreamSynchronize', 'cudaDeviceSynchronize')
    # the host's events: a range also shows on the card's timeline
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    copies = [e.time_range.start for e in events if e.name == 'serve/values_copy']
    if len(copies) != 1:
        raise RuntimeError(f'the profiled flush has {len(copies)} values copies')
    found = [(e.name, e.time_range.start) for e in events if e.name in reads]
    # the host's time in the flush's pinned copies of its fields, against
    # the host's time in rate_batch's own ops (everything between the
    # first field's upload and the values' copy that is not an upload)
    pins = [e for e in events if e.name == 'aten::pin_memory']
    pin_us = sum(e.time_range.end - e.time_range.start for e in pins)
    return {'values_copies': 1,
            'reads': {n: sum(1 for name, _ in found if name == n) for n in reads},
            'before_copy': sorted({name for name, t in found if t < copies[0]}),
            'pin_memory_calls': len(pins), 'pin_memory_host_ms': pin_us / 1e3}


def serve_phase(
    model: VAEP, device: torch.device, card: str = 'CPU', sizes: ServeSizes = ServeSizes(),
    phase4_median_s: Optional[float] = None,
) -> Tuple[Dict[str, int], Dict[str, Any], Dict[str, Any]]:
    """Phase 16: ``RatingService`` over ``model`` at the JAX service's
    default shape, through B1. Returns B1's launches by part, the scenario
    fold's timing (with B1 at the fold's shape on a card) and part (b)'s
    traffic rates.

    The phase does not call ``rate(df)`` (the card's machine has no
    pandas): each request's one-game host staging batch is built from
    seeded arrays (:func:`serve_request`) and submitted where ``rate``
    arrives once it has packed its frame (:func:`submit_request`);
    everything after packing is the service's own code. (a) ``warmup()``
    dispatches every rung of the ladder once (one B1 launch each); (b)
    ``sizes.clients`` closed-loop client threads send ``sizes.requests``
    requests each, every request held to its own one-game references;
    one flush is profiled for host reads; flushes are timed against a
    bare ``rate_batch`` at the same bucket; (c) two versions published in
    a ``ModelRegistry`` under ``build/serve``, swapped while clients
    submit, then rolled back; (d) a breaker drill on an injected clock
    with ``serve.dispatch`` faults; (e) B1's library load made to fail,
    which reaches the request as a ``KernelError``; (f)
    ``close(drain=True)``; (g) ``warmup(scenario_buckets=)`` and three
    scenario requests over one game (an end-location grid, an action-type
    sweep, a custom dense-override grid), entering where
    ``rate_scenarios`` arrives once it has packed its frame
    (:func:`submit_scenario`), each held to the looped materialized
    reference and to a loop of ``rate_batch`` calls, then one take that
    mixes a scenario payload with rate payloads; (h) a ``ParityProbe`` on
    every flush; (i) SLO admission, a loose and an impossible objective;
    (j) a ``serve.dispatch`` fault and a B1 that cannot load under
    scenario flushes; (k) ``telemetry()`` scraped by a fleet aggregator.
    """
    label = f'serve ({device}, {card})'
    A = sizes.max_actions
    rng = np.random.default_rng(16)
    shape = dict(max_actions=A, max_batch_size=sizes.max_batch_size,
                 max_wait_ms=sizes.max_wait_ms, max_queue=sizes.max_queue)
    launches: Dict[str, int] = {}
    t_phase = time.perf_counter()

    def b1() -> int:
        return gm.fused_first_layer_quant.launches

    # -- (a) warm-up: every rung once, past the breaker
    svc = RatingService(model, **shape)
    gm.fused_first_layer_quant.launches = 0
    walls = []
    for b in svc.ladder:
        sync(device)
        t0 = time.perf_counter()
        svc.warmup((b,))
        walls.append(time.perf_counter() - t0)
    launches['warmup'] = b1()
    warm_shapes = svc.compiled_shapes
    if launches['warmup'] != kernel_launches(len(svc.ladder), device) or warm_shapes != len(svc.ladder):
        raise RuntimeError(f"{label}: warm-up launched B1 {launches['warmup']} times over "
                           f'{warm_shapes} shapes for the ladder {svc.ladder}')
    print(f'{label}: (a) warmup {json.dumps({"ladder": list(svc.ladder), "wall_s": walls, "b1": launches["warmup"], "compiled_shapes": warm_shapes})}')

    # -- (b) traffic: closed-loop clients, one game per request
    n_total = sizes.clients * sizes.requests
    reqs = [serve_request(rng, int(rng.integers(sizes.low, A + 1)), A) for _ in range(n_total)]
    results: List[Any] = [None] * n_total
    client_walls = [0.0] * n_total
    errors: List[BaseException] = []

    def client(c: int) -> None:
        try:
            for k in range(sizes.requests):
                i = c * sizes.requests + k
                t0 = time.perf_counter()
                results[i] = submit_request(svc, reqs[i]).result(timeout=300)
                client_walls[i] = time.perf_counter() - t0
        except BaseException as e:  # reported below
            errors.append(e)

    before, takes, snap0 = serve_counts(), count_takes(svc), REGISTRY.snapshot()
    gm.fused_first_layer_quant.launches = 0
    threads = [threading.Thread(target=client, args=(c,)) for c in range(sizes.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sync(device)
    wall = time.perf_counter() - t0
    launches['traffic'] = b1()
    counts = delta(serve_counts(), before)
    segments = segment_means(snap0, REGISTRY.snapshot())
    flushes = list(takes)
    if errors:
        raise RuntimeError(f'{label}: a client failed: {errors[0]!r}')
    n_flushes = len(flushes)
    n_actions = sum(r.n for r in reqs)
    if launches['traffic'] != kernel_launches(n_flushes, device) or counts['fallback_flushes'] != 0:
        raise RuntimeError(f"{label}: {launches['traffic']} B1 launches for {n_flushes} fused "
                           f"flushes, {counts['fallback_flushes']} fallback flushes")
    if svc.compiled_shapes != warm_shapes:
        raise RuntimeError(f'{label}: traffic added shapes: {svc.compiled_shapes} after {warm_shapes}')
    ref_gap = fused_gap = 0.0
    for req, got in zip(reqs, results):
        ref, fused = request_references(model, req, device)
        if got.shape != (req.n, 3) or not np.isfinite(got).all():
            raise RuntimeError(f'{label}: a request came back {got.shape}, finite {np.isfinite(got).all()}')
        ref_gap = max(ref_gap, float(np.abs(got - ref).max()))
        fused_gap = max(fused_gap, float(np.abs(got - fused).max()))
    if not (ref_gap <= SERVE_ATOL and fused_gap <= SERVE_ATOL):
        raise RuntimeError(f'{label}: requests {ref_gap} from rate_batch_reference, {fused_gap} '
                           f'from rate_batch (limit {SERVE_ATOL})')
    buckets: Dict[str, int] = {}
    for _n, b in flushes:
        buckets[str(b)] = buckets.get(str(b), 0) + 1
    walls_sorted = np.sort(client_walls)
    traffic = {
        'requests': n_total, 'actions': n_actions, 'clients': sizes.clients, 'wall_s': wall,
        'requests_per_s': n_total / wall, 'actions_per_s': n_actions / wall,
        'request_seconds_quantiles': series_quantiles('serve/request_seconds', kind='rate'),
        'client_wall_p50_s': float(np.percentile(walls_sorted, 50)),
        'client_wall_p99_s': float(np.percentile(walls_sorted, 99)),
        'flushes': n_flushes, 'flushes_by_reason': {k[8:]: v for k, v in counts.items() if k.startswith('flushes_')},
        'mean_fill_ratio': float(np.mean([n / b for n, b in flushes])),
        'mean_requests_per_flush': n_total / n_flushes, 'buckets': buckets,
        'segment_mean_s': segments,
        'b1_launches': launches['traffic'], 'fallback_flushes': counts['fallback_flushes'],
        'compiled_shapes': svc.compiled_shapes,
        'max_abs_err_vs_reference': ref_gap, 'max_abs_err_vs_rate_batch': fused_gap,
    }
    print(f'{label}: (b) traffic {json.dumps(traffic)}')

    # one flush of a full 64-bucket under the profiler, on this thread: no
    # host read before the values' copy; then flush walls against a bare
    # rate_batch of the same padded batch
    top = svc.ladder[-1]
    payloads = [serve_service._Payload(r.staging, r.gs, keep=(0, r.n)) for r in reqs[:top]]
    gm.fused_first_layer_quant.launches = 0
    reads = profiled_flush_reads(svc, reqs, top, device, label)
    if b1() != kernel_launches(1, device):
        raise RuntimeError(f'{label}: the profiled flush launched B1 {b1()} times')
    cost = {}
    for b in sorted({1, min(16, top), top}):
        def concat_pad(b: int = b) -> Any:
            return serve_service._pad_to_bucket(
                serve_service._concat_games([r.staging for r in reqs[:b]]),
                np.concatenate([r.gs for r in reqs[:b]]), b)

        host, gs = concat_pad()
        batch, overrides = serve_service._upload(host, gs, device)
        flush_s = synced_median(lambda b=b: svc._flush(payloads[:b], b), device)
        pad_s = synced_median(concat_pad, device)
        upload_s = synced_median(lambda: serve_service._upload(host, gs, device), device)
        bare_s = synced_median(lambda: model.rate_batch(batch, dense_overrides=overrides), device)
        copy_s = synced_median(lambda: model.rate_batch(batch, dense_overrides=overrides).cpu(), device)
        # what the parts timed alone leave of the flush: the guards'
        # drain, the slicing, the breaker and the service's metrics
        cost[str(b)] = {'flush_s': flush_s, 'concat_pad_s': pad_s, 'upload_s': upload_s,
                        'rate_batch_s': bare_s, 'rate_batch_and_copy_s': copy_s,
                        'rest_s': flush_s - pad_s - upload_s - copy_s,
                        'actions': int(host.total_actions)}
    print(f'{label}: (b) one flush of {top} requests under the profiler: {json.dumps(reads)}; '
          f'flush against a bare rate_batch of the same padded batch (synced medians): '
          f'{json.dumps(cost)}; phase 4 rate_batch of {GAMES} games: {phase4_median_s}')
    svc.close()

    # -- (c) hot swap and rollback through the registry
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    registry = ModelRegistry(os.path.join(SERVE_DIR, 'registry'), device=device)
    registry.publish('vaep', '1', model)
    registry.publish('vaep', '2', make_model(device, sizes.hidden, head_seed=200))
    registry.activate('vaep', '1')
    versions = {v: registry.load('vaep', v) for v in ('1', '2')}
    svc = RatingService(registry=registry, **shape)
    svc.warmup()
    swap_shapes = svc.compiled_shapes
    n_swap = sizes.swap_clients * sizes.swap_requests
    sreqs = [serve_request(rng, int(rng.integers(sizes.low, A + 1)), A) for _ in range(n_swap)]
    sresults: List[Any] = [None] * n_swap
    submitted = [0.0] * n_swap
    started, swapped = threading.Event(), threading.Event()
    done_lock = threading.Lock()
    done = [0]
    # a quarter of each client's requests go in before the swap starts, the
    # last quarter only after it returns
    quarter = max(1, sizes.swap_requests // 4)

    def swap_client(c: int) -> None:
        try:
            for k in range(sizes.swap_requests):
                if k == sizes.swap_requests - quarter:
                    swapped.wait(timeout=300)  # the last requests go in after the swap
                i = c * sizes.swap_requests + k
                submitted[i] = time.monotonic()
                sresults[i] = submit_request(svc, sreqs[i]).result(timeout=300)
                with done_lock:
                    done[0] += 1
                    if done[0] >= sizes.swap_clients * quarter:
                        started.set()
        except BaseException as e:  # reported below
            errors.append(e)
            started.set()

    before = serve_counts()
    gm.fused_first_layer_quant.launches = 0
    threads = [threading.Thread(target=swap_client, args=(c,)) for c in range(sizes.swap_clients)]
    for t in threads:
        t.start()
    started.wait(timeout=300)
    t0 = time.perf_counter()
    try:
        svc.swap_model('vaep', '2')
    finally:
        swapped.set()
    swap_s = time.perf_counter() - t0
    swap_done = time.monotonic()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f'{label}: a swap client failed: {errors[0]!r}')
    t0 = time.perf_counter()
    svc.rollback_model()
    rollback_s = time.perf_counter() - t0
    back = [submit_request(svc, r).result(timeout=300) for r in sreqs[: sizes.swap_clients]]
    launches['swap'] = b1()
    counts = delta(serve_counts(), before)
    by_version = {'1': 0, '2': 0}
    after_swap = 0
    for req, got, t_sub in zip(sreqs, sresults, submitted):
        gaps = {v: float(np.abs(got - request_references(m, req, device)[0]).max())
                for v, m in versions.items()}
        match = [v for v, g in gaps.items() if g <= SERVE_ATOL]
        other = [v for v, g in gaps.items() if g > SERVE_APART]
        if len(match) != 1 or len(other) != 1:
            raise RuntimeError(f'{label}: a request is not wholly one version: {gaps}')
        by_version[match[0]] += 1
        if t_sub > swap_done:
            after_swap += 1
            if match[0] != '2':
                raise RuntimeError(f'{label}: a request submitted after the swap was rated by v1')
    for req, got in zip(sreqs, back):
        if float(np.abs(got - request_references(versions['1'], req, device)[0]).max()) > SERVE_ATOL:
            raise RuntimeError(f'{label}: after rollback a request was not rated by v1')
    if registry.active()[:2] != ('vaep', '1') or svc.compiled_shapes != swap_shapes or after_swap == 0:
        raise RuntimeError(f'{label}: after rollback {registry.active()[:2]}, shapes '
                           f'{svc.compiled_shapes} (warm {swap_shapes}), {after_swap} after the swap')
    swap = {'requests': n_swap, 'by_version': by_version, 'submitted_after_swap': after_swap,
            'swap_wall_s': swap_s, 'rollback_wall_s': rollback_s,
            'model_swaps': counts['swaps'], 'model_swaps_rollback': counts['rollbacks'],
            'compiled_shapes': svc.compiled_shapes, 'b1_launches': launches['swap']}
    print(f'{label}: (c) hot swap and rollback {json.dumps(swap)}')
    svc.close()

    # -- (d) breaker drill: injected serve.dispatch faults on calls 1 and 2
    clock = {'t': 0.0}
    breaker = CircuitBreaker(failure_threshold=2, recovery_time_s=SERVE_RECOVERY_S,
                             clock=lambda: clock['t'])
    svc = RatingService(model, breaker=breaker, **shape)
    svc.warmup()
    dreq = sreqs[0]
    dref = request_references(model, dreq, device)[0]
    before = serve_counts()
    gm.fused_first_layer_quant.launches = 0
    drill = []
    with FaultPlan(seed=16, specs=[FaultSpec('serve.dispatch', error=RuntimeError, on_calls=(1, 2))]):
        for step in range(4):
            if step == 3:
                clock['t'] += 2 * SERVE_RECOVERY_S
            got = submit_request(svc, dreq).result(timeout=300)
            gap = float(np.abs(got - dref).max())
            drill.append({'state': breaker.state, 'health': svc.health()['status'], 'b1': b1(),
                          'max_abs_err': gap})
            if gap > SERVE_ATOL:
                raise RuntimeError(f'{label}: breaker drill step {step} is {gap} from its reference')
    launches['breaker drill'] = b1()
    counts = delta(serve_counts(), before)
    want = [('closed', 'ok', 0), ('open', 'degraded', 0), ('open', 'degraded', 0),
            ('closed', 'ok', kernel_launches(1, device))]
    if [(d['state'], d['health'], d['b1']) for d in drill] != want or counts['fallback_flushes'] != 3:
        raise RuntimeError(f'{label}: breaker drill {drill}, fallback flushes {counts["fallback_flushes"]}')
    print(f'{label}: (d) breaker drill {json.dumps({"steps": drill, "fallback_flushes": counts["fallback_flushes"], "trips": breaker.trips})}')

    # -- (e) kernel-fault drill: B1 cannot run; never degraded
    breaker_before = breaker.to_dict()
    before = serve_counts()
    gm.fused_first_layer_quant.launches = 0

    def no_b1(*args: Any, **kwargs: Any) -> Any:
        if device.type == 'cuda':
            raise OSError('libgather_matmul.so: cannot open shared object file (kernel-fault drill)')
        raise cuda_build.KernelError('gather_matmul cannot be loaded (kernel-fault drill)')

    # on the card the wrapper's library load fails as dlopen would, and the
    # wrapper must raise that as a KernelError; on the CPU, where the wrapper
    # runs its plain version and loads nothing, the wrapper itself raises
    patched = (cuda_build, 'load_library') if device.type == 'cuda' else (fused_ops, 'fused_first_layer_quant')
    real = getattr(*patched)
    setattr(*patched, no_b1)
    try:
        fut = submit_request(svc, dreq)
        try:
            fut.result(timeout=300)
            raised = None
        except cuda_build.KernelError as e:
            raised = str(e)
    finally:
        setattr(*patched, real)
    counts_fault = delta(serve_counts(), before)
    if raised is None or breaker.to_dict() != breaker_before or counts_fault['fallback_flushes'] != 0:
        raise RuntimeError(f'{label}: kernel-fault drill: raised {raised}, breaker '
                           f'{breaker.to_dict()} (was {breaker_before}), fallback {counts_fault}')
    got = submit_request(svc, dreq).result(timeout=300)
    launches['kernel-fault drill'] = b1()
    gap = float(np.abs(got - dref).max())
    if launches['kernel-fault drill'] != kernel_launches(1, device) or gap > SERVE_ATOL:
        raise RuntimeError(f"{label}: after the kernel-fault drill B1 launched "
                           f"{launches['kernel-fault drill']} times, values {gap} off")
    print(f'{label}: (e) kernel-fault drill {json.dumps({"future_raised": raised, "breaker": breaker.to_dict()["state"], "consecutive_failures": breaker.to_dict()["consecutive_failures"], "fallback_flushes": counts_fault["fallback_flushes"], "health": svc.health()["status"], "b1_after_restore": launches["kernel-fault drill"], "max_abs_err": gap})}')
    svc.close()

    # -- (f) close(drain=True) resolves what is queued
    svc = RatingService(model, **{**shape, 'max_wait_ms': 600_000.0})
    gm.fused_first_layer_quant.launches = 0
    queued = [submit_request(svc, r) for r in sreqs[: sizes.drain_requests]]
    depth = svc._batcher.queue_depth
    svc.close(drain=True)
    launches['close'] = b1()
    gaps = [float(np.abs(f.result(timeout=300) - request_references(model, r, device)[0]).max())
            for f, r in zip(queued, sreqs)]
    try:
        submit_request(svc, sreqs[0])
        late = None
    except RuntimeError as e:
        late = str(e)
    if depth != sizes.drain_requests or max(gaps) > SERVE_ATOL or late is None or \
            launches['close'] != kernel_launches(1, device):
        raise RuntimeError(f"{label}: close(drain=True): depth {depth}, gaps {gaps}, late {late}, "
                           f"B1 {launches['close']}")
    print(f'{label}: (f) close(drain=True) {json.dumps({"queued": depth, "resolved": len(gaps), "max_abs_err": max(gaps), "submit_after_close": late, "b1": launches["close"]})}')

    # -- (g) scenarios: the verb's folded flushes through B1
    t_part = time.perf_counter()
    part_walls: Dict[str, float] = {}
    nx, ny = sizes.grid
    scen_bucket = bucket_perturbations(nx * ny)
    game = serve_request(rng, A, A)
    width = model._dense_override_widths()['time_delta']
    grids = {
        'end_location_grid': end_location_grid(nx, ny),
        'action_type_sweep': action_type_sweep(range(sizes.sweep_types)),
        'custom_grid': custom_grid(dense_overrides={'time_delta': np.random.default_rng(160).normal(
            0, 5, size=(sizes.custom_p, 1, A, width)).astype(np.float32)}),
    }
    svc = RatingService(model, **shape)
    gm.fused_first_layer_quant.launches = 0
    svc.warmup(scenario_buckets=(scen_bucket,))
    launches['scenario warmup'] = b1()
    warm_shapes = len(set(svc.ladder) | {scen_bucket})
    if launches['scenario warmup'] != kernel_launches(warm_shapes, device) or \
            svc.compiled_shapes != warm_shapes:
        raise RuntimeError(f"{label}: scenario warm-up launched B1 {launches['scenario warmup']} "
                           f'times over {svc.compiled_shapes} shapes')
    before, scen_before = serve_counts(), scenario_counts()
    gm.fused_first_layer_quant.launches = 0
    outs = {name: submit_scenario(svc, game, g).result(timeout=300) for name, g in grids.items()}
    launches['scenarios'] = b1()
    scen = delta(scenario_counts(), scen_before)
    counts = delta(serve_counts(), before)
    if launches['scenarios'] != kernel_launches(scen['dispatches'], device) or \
            scen['dispatches'] != len(grids) or scen['fallbacks'] or counts['fallback_flushes'] or \
            svc.compiled_shapes != warm_shapes:
        raise RuntimeError(f"{label}: {launches['scenarios']} B1 launches for scenario flushes "
                           f'{scen}, fallback {counts}, shapes {svc.compiled_shapes}')
    # references outside the counted run: the looped materialized oracle
    # and the loop of one rate_batch a perturbation, on the card
    gbatch, goverrides = serve_service._upload(game.staging, game.gs, device)
    refs: Dict[str, np.ndarray] = {}
    scenarios: Dict[str, Any] = {}
    for name, g in grids.items():
        got = outs[name]
        ref = rate_scenarios_reference(model, gbatch, g, dense_overrides=goverrides)
        loop = rate_scenarios_looped(model, gbatch, g, dense_overrides=goverrides, bucket=False)
        refs[name] = ref[:, 0, : game.n].cpu().numpy()
        loop = loop[:, 0, : game.n].cpu().numpy()
        P = g.n_perturbations
        if got.shape != (P, game.n, 3) or not np.isfinite(got).all():
            raise RuntimeError(f'{label}: {name} came back {got.shape}')
        scenarios[name] = {'perturbations': P, 'bucket': bucket_perturbations(P),
                           'rows': bucket_perturbations(P) * A,
                           'max_abs_err_vs_reference': float(np.abs(got - refs[name]).max()),
                           'max_abs_err_vs_rate_batch_loop': float(np.abs(got - loop).max())}
        if max(scenarios[name]['max_abs_err_vs_reference'],
               scenarios[name]['max_abs_err_vs_rate_batch_loop']) > SERVE_ATOL:
            raise RuntimeError(f'{label}: {name} {scenarios[name]} (limit {SERVE_ATOL})')
    del gbatch, goverrides
    # the folded flush against a bare rate_batch of its padded batch
    fold = grids['end_location_grid']
    payload = serve_service._ScenarioPayload(game.staging, game.gs, fold)
    flush_s = synced_median(lambda: svc._flush([payload], 1), device)
    expanded, _ = expand_scenarios(game.staging, pad_perturbations(fold, scen_bucket))
    ebatch, eoverrides = serve_service._upload(expanded, np.tile(game.gs, (scen_bucket, 1, 1)), device)
    bare_s = synced_median(lambda: model.rate_batch(ebatch, dense_overrides=eoverrides, bucket=False),
                           device)
    fold_b1 = fold_first_layer(model, ebatch, eoverrides) if device.type == 'cuda' else None
    del ebatch, eoverrides, expanded
    svc.close()
    timing = {'perturbations': fold.n_perturbations, 'bucket': scen_bucket, 'actions': game.n,
              'flush_s': flush_s, 'values_per_s': fold.n_perturbations * game.n / flush_s,
              'bare_rate_batch_s': bare_s, 'b1_at_fold_shape': fold_b1}
    # one take of 3 rate payloads and a scenario payload: two dispatches
    mix = RatingService(model, **{**shape, 'max_wait_ms': 600_000.0})
    takes = count_takes(mix)
    gm.fused_first_layer_quant.launches = 0
    futs = [submit_request(mix, reqs[0]), submit_request(mix, reqs[1]),
            submit_scenario(mix, game, grids['action_type_sweep']), submit_request(mix, reqs[2])]
    mix.close(drain=True)
    mixed = [f.result(timeout=300) for f in futs]
    launches['mixed take'] = b1()
    mix_gaps = [float(np.abs(mixed[i] - request_references(model, reqs[j], device)[0]).max())
                for i, j in ((0, 0), (1, 1), (3, 2))]
    mix_gaps.append(float(np.abs(mixed[2] - refs['action_type_sweep']).max()))
    if takes != [(4, 4)] or launches['mixed take'] != kernel_launches(2, device) or \
            max(mix_gaps) > SERVE_ATOL or mixed[2].shape != (sizes.sweep_types, game.n, 3):
        raise RuntimeError(f"{label}: the mixed take {takes} launched B1 {launches['mixed take']} "
                           f'times, gaps {mix_gaps}')
    part_walls['g'] = time.perf_counter() - t_part
    print(f'{label}: (g) scenarios {json.dumps({"warmup_b1": launches["scenario warmup"], "compiled_shapes": warm_shapes, "b1": launches["scenarios"], "scenario_flushes": scen, "requests": scenarios, "fold_flush": timing, "mixed_take": {"takes": takes, "b1": launches["mixed take"], "max_abs_err": max(mix_gaps)}})}')

    # -- (h) the parity probe under the flushes
    t_part = time.perf_counter()
    n_probe = sizes.probe_clients * sizes.probe_requests
    probe = ParityProbe(sample_rate=1.0, max_abs_err=SERVE_PROBE_BAND, queue_size=n_probe + 1)
    svc = RatingService(model, parity=probe, **shape)
    svc.warmup()
    takes = count_takes(svc)
    gm.fused_first_layer_quant.launches = 0
    probed = run_clients(svc, reqs[:n_probe], sizes.probe_clients)
    sync(device)
    launches['parity probe'] = b1()
    if not probe.flush(timeout=300):
        raise RuntimeError(f'{label}: the probe did not finish')
    stats = probe.stats()
    n_flushes = len(takes)
    probe_gap = max(float(np.abs(got - request_references(model, r, device)[0]).max())
                    for r, got in zip(reqs, probed))
    if stats['probes'] != n_flushes or stats['exceedances'] or stats['errors'] or \
            not stats['max_abs_err'] <= SERVE_PROBE_BAND or probe_gap > SERVE_ATOL or \
            launches['parity probe'] != kernel_launches(n_flushes, device):
        raise RuntimeError(f"{label}: probe {stats} over {n_flushes} flushes, B1 "
                           f"{launches['parity probe']}, requests {probe_gap} off")
    probe_reads = profiled_flush_reads(svc, reqs, top, device, f'{label}: probed')
    if not probe.flush(timeout=300) or probe.stats()['probes'] != n_flushes + 1 or \
            probe.stats()['exceedances']:
        raise RuntimeError(f'{label}: the probed flush\'s probe {probe.stats()}')
    health = svc.health()
    svc.close()
    part_walls['h'] = time.perf_counter() - t_part
    print(f'{label}: (h) parity probe {json.dumps({"requests": n_probe, "flushes": n_flushes, "b1": launches["parity probe"], "probes": stats["probes"], "exceedances": stats["exceedances"], "max_abs_err": stats["max_abs_err"], "max_ulp_err": stats["max_ulp_err"], "band": SERVE_PROBE_BAND, "requests_max_abs_err": probe_gap, "profiled_flush": probe_reads, "health": health["status"], "closed_with_the_service": probe.should_sample() is False})}')

    # -- (i) SLO admission: a loose objective sheds nothing, an impossible
    # one sheds by burn rate (tests/test_slo.py's forced burn)
    t_part = time.perf_counter()
    shed_before = metric_total('slo/shed_total')
    svc = RatingService(model, slo=SLOConfig.simple(latency_ms=1000.0), **shape)
    svc.warmup()
    gm.fused_first_layer_quant.launches = 0
    run_clients(svc, reqs[:n_probe], sizes.probe_clients, admit=True)
    launches['slo'] = b1()
    loose = svc.health()['slo']
    loose_shed = metric_total('slo/shed_total') - shed_before
    svc.close()
    if loose_shed or loose['shedding']:
        raise RuntimeError(f'{label}: a loose objective shed {loose_shed}: {loose}')
    svc = RatingService(model, slo=SLOConfig.simple(
        latency_ms=1e-6, latency_target=0.9, fast_window_s=0.5, slow_window_s=1.0,
        min_events=4, shed_burn_rate=1.0, eval_interval_s=0.0), **shape)
    # warm, as the loose service is: the shed and health() must read the
    # same events, so all four must fall inside the 0.5 s fast window
    svc.warmup()
    shed_at, reason = None, None
    for i, r in enumerate(reqs[:16]):
        try:
            submit_request(svc, r, admit=True).result(timeout=300)
        except SLOShed as e:
            shed_at, reason = i, e.reason
            break
    tight = svc.health()['slo']
    tight_shed = metric_total('slo/shed_total') - shed_before
    svc.close()
    if shed_at is None or reason['objective'] != 'latency' or not reason['burn_rate_fast'] > 1.0 \
            or not reason['burn_rate_slow'] > 1.0 or tight_shed < 1 or not tight['shedding']:
        raise RuntimeError(f'{label}: the impossible objective: shed at {shed_at}, {reason}, '
                           f'{tight_shed} counted, health {tight}')
    part_walls['i'] = time.perf_counter() - t_part
    print(f'{label}: (i) SLO {json.dumps({"loose": {"requests": n_probe, "shed": loose_shed, "shedding": loose["shedding"], "request_p99_ms": loose["request_p99_ms"], "b1": launches["slo"]}, "impossible": {"shed_at_request": shed_at, "reason": reason, "shed_total": tight_shed, "shedding": tight["shedding"]}})}')

    # -- (j) the scenario breaker, and a kernel that cannot run
    t_part = time.perf_counter()
    sweep = grids['action_type_sweep']
    svc = RatingService(model, **shape)
    before = scenario_counts()
    gm.fused_first_layer_quant.launches = 0
    with FaultPlan(seed=16, specs=[FaultSpec('serve.dispatch', error=RuntimeError, nth=1)]):
        degraded = submit_scenario(svc, game, sweep).result(timeout=300)
    launches['scenario breaker drill'] = b1()
    drill = delta(scenario_counts(), before)
    degraded_gap = float(np.abs(degraded - refs['action_type_sweep']).max())
    breaker_after = svc.breaker.to_dict()
    if drill != {'dispatches': 0, 'fallbacks': 1, 'fallback_flushes': 1} or degraded_gap > SERVE_ATOL \
            or launches['scenario breaker drill'] != 0 or breaker_after['consecutive_failures'] != 1:
        raise RuntimeError(f'{label}: scenario breaker drill {drill}, {degraded_gap} off, B1 '
                           f"{launches['scenario breaker drill']}, breaker {breaker_after}")
    before = scenario_counts()
    gm.fused_first_layer_quant.launches = 0
    real = getattr(*patched)
    setattr(*patched, no_b1)
    try:
        fut = submit_scenario(svc, game, sweep)
        try:
            fut.result(timeout=300)
            scen_raised = None
        except cuda_build.KernelError as e:
            scen_raised = str(e)
    finally:
        setattr(*patched, real)
    fault = delta(scenario_counts(), before)
    unmoved = svc.breaker.to_dict() == breaker_after
    if scen_raised is None or not unmoved or fault['fallbacks'] or fault['fallback_flushes']:
        raise RuntimeError(f'{label}: scenario kernel-fault drill: raised {scen_raised}, breaker '
                           f'{svc.breaker.to_dict()} (was {breaker_after}), {fault}')
    again = submit_scenario(svc, game, sweep).result(timeout=300)
    launches['scenario kernel-fault drill'] = b1()
    again_gap = float(np.abs(again - refs['action_type_sweep']).max())
    if launches['scenario kernel-fault drill'] != kernel_launches(1, device) or again_gap > SERVE_ATOL:
        raise RuntimeError(f"{label}: after the scenario kernel-fault drill B1 launched "
                           f"{launches['scenario kernel-fault drill']} times, values {again_gap} off")
    svc.close()
    part_walls['j'] = time.perf_counter() - t_part
    print(f'{label}: (j) scenario breaker and kernel-fault drills {json.dumps({"fault_at_dispatch": {"counts": drill, "max_abs_err_vs_reference": degraded_gap, "b1": launches["scenario breaker drill"], "breaker": breaker_after["state"], "consecutive_failures": breaker_after["consecutive_failures"]}, "b1_cannot_load": {"future_raised": scen_raised, "counts": fault, "breaker_unmoved": unmoved, "b1_after_restore": launches["scenario kernel-fault drill"], "max_abs_err": again_gap}})}')

    # -- (k) telemetry(): the service's rows on the fleet's scrape surface
    t_part = time.perf_counter()
    svc = RatingService(model, **shape)
    gm.fused_first_layer_quant.launches = 0
    for r in reqs[: sizes.telemetry_requests]:
        submit_request(svc, r).result(timeout=300)
    launches['telemetry'] = b1()
    sock = os.path.join(SERVE_DIR, 'serve-0.sock')
    with serve_telemetry(telemetry=svc.telemetry(replica='serve-0'), unix_path=sock):
        health = svc.health()
        scraped = scrape_health(sock, timeout=5.0)
        aggregator = FleetAggregator({'serve-0': sock}, registry=MetricRegistry())
        outcome = aggregator.scrape()
        rows = {r['signal']: r for r in aggregator.aggregate().divergence}
    svc.close()
    want_rows = {'request_p99_s': health['slo']['request_p99_ms'] / 1e3,
                 'breaker_state': BREAKER_CODES[health['breaker']['state']]}
    got_rows = {k: rows[k]['value'] for k in want_rows if k in rows}
    if outcome != {'serve-0': True} or set(got_rows) != set(want_rows) or \
            any(abs(got_rows[k] - v) > 1e-12 * max(1.0, abs(v)) for k, v in want_rows.items()) or \
            scraped['breaker'] != health['breaker'] or \
            launches['telemetry'] != kernel_launches(sizes.telemetry_requests, device):
        raise RuntimeError(f'{label}: telemetry scrape {outcome}, rows {got_rows} against health '
                           f"{want_rows}, B1 {launches['telemetry']}")
    part_walls['k'] = time.perf_counter() - t_part
    print(f'{label}: (k) telemetry {json.dumps({"scrape": outcome, "rows": {k: rows[k] for k in want_rows}, "health": want_rows, "status": scraped["status"]})}')
    print(f'{label}: (g) to (k) walls (s) {json.dumps(part_walls)}')
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    print(f'{label}: B1 launches {json.dumps(launches)}; phase 16 in {time.perf_counter() - t_phase:.1f} s')
    one_lane = {k: traffic[k] for k in ('requests', 'wall_s', 'requests_per_s', 'actions_per_s',
                                         'client_wall_p50_s', 'client_wall_p99_s', 'flushes')}
    return launches, timing, one_lane


# -- phase 17: serving's outer tier ---------------------------------------------------------

#: Where phase 17 writes its registries, the warm tier's children's caches
#: and reports, and the frontend's socket (git-ignored, removed at the end).
LANES_DIR = os.path.join('build', 'lanes')
#: Seconds a warm-tier child may take, start to end (the stale child
#: builds both libraries with nvcc).
AOT_CHILD_TIMEOUT_S = 300.0
#: A lane service's construction must allocate less than this (no weights).
LANE_BUILD_BYTES = 1 << 20


class LaneSizes(NamedTuple):
    """Phase 17's shapes: phase 16's service shape behind ``lanes`` replica
    lanes, phase 16's traffic, the one-request flushes held bitwise and the
    drills' requests."""

    max_actions: int = ACTIONS
    max_batch_size: int = 64
    max_wait_ms: float = 2.0
    max_queue: int = 256
    lanes: int = 4
    clients: int = 16
    requests: int = 32
    low: int = 1200
    single: int = 16
    drill_requests: int = 16
    hidden: Tuple[int, ...] = HIDDEN


def requested_bytes(device: torch.device) -> Optional[int]:
    """The caching allocator's requested bytes on a card (None on the CPU)."""
    if device.type != 'cuda':
        return None
    return int(torch.cuda.memory_stats(device).get('requested_bytes.all.current', 0))


def reference_values(model: VAEP, req: ServeRequest, device: torch.device) -> np.ndarray:
    """``rate_batch_reference`` of the request's own one-game batch."""
    batch, overrides = serve_service._upload(req.staging, req.gs, device)
    return model.rate_batch_reference(batch, dense_overrides=overrides)[0, : req.n].cpu().numpy()


def count_lane_takes(svc: RatingService) -> List[Tuple[int, int, int]]:
    """Record ``(requests, bucket, lane)`` of every flush the service's
    lanes run from now on; returns the list they append to."""
    takes: List[Tuple[int, int, int]] = []
    lock = threading.Lock()
    real = svc._batcher._runner

    def runner(payloads: List[Any], bucket: int, *, lane: int = 0) -> List[Any]:
        with lock:
            takes.append((len(payloads), bucket, lane))
        return real(payloads, bucket, lane=lane)

    svc._batcher._runner = runner
    return takes


def timed_clients(
    svc: RatingService, reqs: List[ServeRequest], clients: int,
) -> Tuple[List[Any], List[float], float]:
    """``reqs`` from ``clients`` closed-loop client threads (each its own
    contiguous share): the results in request order, each request's wall
    and the run's wall."""
    per = len(reqs) // clients
    results: List[Any] = [None] * len(reqs)
    walls = [0.0] * len(reqs)
    errors: List[BaseException] = []

    def client(c: int) -> None:
        try:
            for i in range(c * per, (c + 1) * per):
                t0 = time.perf_counter()
                results[i] = submit_request(svc, reqs[i]).result(timeout=300)
                walls[i] = time.perf_counter() - t0
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f'a client failed: {errors[0]!r}')
    return results, walls, wall


def traffic_record(reqs: List[ServeRequest], walls: List[float], wall: float) -> Dict[str, Any]:
    n = len(reqs)
    return {'requests': n, 'actions': sum(r.n for r in reqs), 'wall_s': wall,
            'requests_per_s': n / wall, 'actions_per_s': sum(r.n for r in reqs) / wall,
            'client_wall_p50_s': float(np.percentile(walls, 50)),
            'client_wall_p99_s': float(np.percentile(walls, 99))}


def lane_segment_means(before: Any, after: Any, replicas: Tuple[str, ...]) -> Dict[str, float]:
    """:func:`segment_means` over every lane's ``replica=`` series."""
    out = {}
    for seg_name in ('queue_wait', 'pad', 'dispatch', 'slice'):
        n = total = 0.0
        for rid in replicas:
            a = after.series('serve/segment_seconds', segment=seg_name, replica=rid)
            b = before.series('serve/segment_seconds', segment=seg_name, replica=rid)
            n += (a.count if a else 0) - (b.count if b else 0)
            total += (a.total if a else 0.0) - (b.total if b else 0.0)
        if n:
            out[seg_name] = total / n
    return out


def lane_fallbacks(svc: RatingService) -> Dict[str, float]:
    snap = REGISTRY.snapshot()
    return {rid: snap.value('serve/fallback_flushes', replica=rid) for rid in svc.replica_ids}


def stand_in_libraries(cache_dir: str) -> None:
    """The CPU has no ``nvcc``: a rehearsal of the warm tier ships stand-in
    shared objects (extension modules of this interpreter) in place of the
    two kernel libraries, written where the build would have put them."""
    import importlib

    found = []
    for name in ('_ctypes', '_json', '_struct', '_bisect', '_heapq', 'select', '_socket'):
        path = getattr(importlib.import_module(name), '__file__', None) or ''
        if path.endswith('.so'):
            found.append(path)
    os.makedirs(cache_dir, exist_ok=True)
    with compile_cache(cache_dir):
        for name, so in zip(KERNELS, found):
            shutil.copyfile(so, cuda_build.library_path(name))


@contextlib.contextmanager
def compile_cache(path: str) -> Any:
    """``SOCCERACTION_TPU_COMPILE_CACHE`` set to ``path`` inside the block."""
    old = os.environ.get(COMPILE_CACHE_ENV)
    os.environ[COMPILE_CACHE_ENV] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(COMPILE_CACHE_ENV, None)
        else:
            os.environ[COMPILE_CACHE_ENV] = old


def aot_replica(root: str, version: str, device_type: str) -> None:
    """One of phase 17 (b)'s warm-tier children, spawned by
    :func:`lanes_phase` with an empty ``SOCCERACTION_TPU_COMPILE_CACHE``.

    A replica's cold start, phase by phase on its own timeline: the import,
    the registry's load of ``version`` (``checkpoint_load``), the warm tier
    (``aot_deserialize``: ``load_aot``), the kernels' libraries
    (``kernel_build``: installed ones load, missing ones build with
    ``nvcc``), and the first request through the service
    (``first_dispatch``). It writes its report and its values."""
    with TIMELINE.phase('import', start_unix=TIMELINE.begin()):
        pass
    # with no card this raises: a replica never rates on the CPU in its place
    device = resolve_device(device_type)
    if device.type == 'cuda':
        set_precision()
    with open(os.path.join(root, 'spec.json'), encoding='utf-8') as fh:
        spec = json.load(fh)
    with TIMELINE.phase('checkpoint_load'):
        registry = ModelRegistry(os.path.join(root, 'registry'), device=device)
        registry.activate('vaep', version)
    svc = RatingService(registry=registry, **spec['shape'])
    with TIMELINE.phase('aot_deserialize'):
        state = svc.load_aot() or {}
    snap = REGISTRY.snapshot()
    with TIMELINE.phase('kernel_build'):
        if device.type == 'cuda':  # the CPU's wrappers load no library
            cuda_build.load_libraries(KERNELS)
    saved = np.load(os.path.join(root, 'request.npz'))
    staging = ActionBatch(**{k[2:]: saved[k] for k in saved.files if k.startswith('f_')})
    req = ServeRequest(staging, saved['gs'], int(saved['n']))
    gm.fused_first_layer_quant.launches = 0
    with TIMELINE.phase('first_dispatch'):
        values = submit_request(svc, req).result(timeout=300)
    TIMELINE.mark('first_rated_action')
    svc.close()
    snap = REGISTRY.snapshot()
    np.save(os.path.join(root, f'values-{version}.npy'), values)
    write_json(os.path.join(root, f'report-{version}.json'), {
        'version': version,
        'aot': {k: state.get(k) for k in ('outcome', 'entries_loaded', 'reason', 'mismatch')},
        'aot_loads': {o: snap.value('serve/aot_loads', outcome=o) for o in ('hit', 'stale', 'miss')},
        'kernel_builds': sum(snap.value('dispatch/kernel_builds', kernel=k) for k in KERNELS),
        'build_seconds': dict(cuda_build.build_seconds),
        'compile_cache': compile_cache_dir(),
        'installed': {k: os.path.exists(cuda_build.library_path(k)) for k in KERNELS},
        'library_paths': {k: str(p) for k, p in cuda_build._paths.items()},
        'b1_launches': gm.fused_first_layer_quant.launches,
        'coldstart': coldstart_report(),
    })


def spawn_aot_replicas(root: str, versions: Tuple[str, ...], device: torch.device) -> Dict[str, Dict[str, Any]]:
    """Start one warm-tier child a version, all at once (as replicas of a
    scale-out start), each from an empty compile cache of its own; returns
    each one's report with its values and its wall. A child that fails or
    outlives :data:`AOT_CHILD_TIMEOUT_S` fails the phase, and every child
    still running is killed."""
    env = dict(os.environ)
    if device.type == 'cpu':
        env['OMP_NUM_THREADS'] = '1'
    procs: Dict[str, Tuple[subprocess.Popen, float, str]] = {}
    try:
        for version in versions:
            log = os.path.join(root, f'child-{version}.log')
            with open(log, 'w') as fh:
                procs[version] = (subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), '--aot-replica', root, version,
                     device.type],
                    stdout=fh, stderr=subprocess.STDOUT,
                    env={**env, COMPILE_CACHE_ENV: os.path.join(root, f'cache-{version}')},
                ), time.perf_counter(), log)
        deadline = time.monotonic() + AOT_CHILD_TIMEOUT_S
        reports = {}
        for version, (proc, t0, log) in procs.items():
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            wall = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f'warm-tier child {version} exited {rc}:\n{fleet_tail(log)}')
            with open(os.path.join(root, f'report-{version}.json'), encoding='utf-8') as fh:
                report = json.load(fh)
            report['values'] = np.load(os.path.join(root, f'values-{version}.npy'))
            report['spawn_wall_s'] = wall
            report['cache'] = os.path.join(root, f'cache-{version}')
            reports[version] = report
        return reports
    finally:
        for proc, _t0, _log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def lanes_phase(
    model: VAEP, device: torch.device, card: str = 'CPU', sizes: LaneSizes = LaneSizes(),
    one_lane: Optional[Dict[str, Any]] = None,
) -> Dict[str, int]:
    """Phase 17: serving's outer tier over ``model``. Returns B1's launches
    by part.

    (a) A ``RatingService(n_replicas=sizes.lanes)`` at phase 16's shape:
    its construction allocates no weights (every lane aliases the model's
    fold and heads); warm-up dispatches every rung on every lane; phase
    16's traffic (16 closed-loop clients x 32 one-game requests) through a
    one-lane service and through the lanes, every lane flushing, B1
    launches equal to the fused flushes, no fallback, no new shape, every
    request within 1e-5 of its ``rate_batch_reference`` and of the one-lane
    service's value; one-request flushes bitwise the one-lane service's;
    ``GET /health`` through a ``ServingFrontend`` on a unix socket equal to
    ``health()`` (part (c)); a sick lane (its breaker tripped) named by
    ``health()`` while the others serve; B1 that cannot load on one lane's
    stream failing that lane's flush with ``KernelError``, its breaker and
    the fallback count unmoved; a swap that fails when lane 1's warm-up
    fails, with no lane serving the new version, then lands on every lane.
    (b) The warm tier: a version published with ``aot=`` (and a copy whose
    manifest claims another card and toolkit), each started in a child
    process from an empty compile cache (``--aot-replica``), both at once:
    the hit child installs both libraries and runs no ``nvcc``, the stale
    child builds them; both rate one request bitwise as this process does.
    """
    label = f'lanes ({sizes.lanes} lanes on {device}, {card})'
    A, L = sizes.max_actions, sizes.lanes
    rng = np.random.default_rng(17)
    shape = dict(max_actions=A, max_batch_size=sizes.max_batch_size,
                 max_wait_ms=sizes.max_wait_ms, max_queue=sizes.max_queue)
    launches: Dict[str, int] = {}
    t_phase = time.perf_counter()
    shutil.rmtree(LANES_DIR, ignore_errors=True)
    os.makedirs(LANES_DIR, mode=0o700)

    def b1() -> int:
        return gm.fused_first_layer_quant.launches

    # -- (a) lanes share the weights; every lane warms its ladder
    prep = model._prepared_pair()
    sync(device)
    before_bytes = requested_bytes(device)
    svc = RatingService(model, n_replicas=L, **shape)
    build_bytes = None if before_bytes is None else requested_bytes(device) - before_bytes
    aliased = all(lp.tables.data is prep.tables.data and lp.w_dense.data is prep.w_dense.data
                  and lp.bias is prep.bias for lp, _a, _b in svc._dispatcher_for(model)._lanes)
    streams = {s.cuda_stream for s in svc._lane_streams if s is not None}
    if not aliased or (build_bytes is not None and build_bytes >= LANE_BUILD_BYTES) or \
            len(streams) != (L if device.type == 'cuda' else 0):
        raise RuntimeError(f'{label}: lanes aliased {aliased}, construction requested '
                           f'{build_bytes} bytes, {len(streams)} streams')
    gm.fused_first_layer_quant.launches = 0
    t0 = time.perf_counter()
    svc.warmup()
    warm_s = time.perf_counter() - t0
    launches['warmup'] = b1()
    warm_shapes, ladder = svc.compiled_shapes, svc.ladder
    if launches['warmup'] != kernel_launches(L * len(svc.ladder), device) or \
            warm_shapes != L * len(svc.ladder):
        raise RuntimeError(f"{label}: warm-up launched B1 {launches['warmup']} times over "
                           f'{warm_shapes} shapes for {L} lanes x {svc.ladder}')
    print(f'{label}: (a) construction {json.dumps({"lanes": L, "devices": [str(d) for d in svc._lane_devices], "streams": len(streams), "aliased_weights": aliased, "requested_bytes": build_bytes})}; warm-up {json.dumps({"b1": launches["warmup"], "compiled_shapes": warm_shapes, "wall_s": warm_s})}')

    # -- the same traffic through one lane, then through the lanes
    one = RatingService(model, **shape)
    gm.fused_first_layer_quant.launches = 0
    one.warmup()
    launches['one-lane warmup'] = b1()
    n_total = sizes.clients * sizes.requests
    reqs = [serve_request(rng, int(rng.integers(sizes.low, A + 1)), A) for _ in range(n_total)]
    one_takes = count_lane_takes(one)
    snap0 = REGISTRY.snapshot()
    gm.fused_first_layer_quant.launches = 0
    one_res, one_walls, one_wall = timed_clients(one, reqs, sizes.clients)
    sync(device)
    launches['one-lane traffic'] = b1()
    if launches['one-lane traffic'] != kernel_launches(len(one_takes), device):
        raise RuntimeError(f"{label}: the one-lane service launched B1 {launches['one-lane traffic']} "
                           f'times for {len(one_takes)} flushes')
    one_segments = segment_means(snap0, REGISTRY.snapshot())
    takes = count_lane_takes(svc)
    before, snap0 = serve_counts(), REGISTRY.snapshot()
    gm.fused_first_layer_quant.launches = 0
    res, walls, wall = timed_clients(svc, reqs, sizes.clients)
    sync(device)
    launches['traffic'] = b1()
    segments = lane_segment_means(snap0, REGISTRY.snapshot(), svc.replica_ids)
    counts = delta(serve_counts(), before)
    by_lane = {rid: sum(1 for *_x, lane in takes if lane == i) for i, rid in enumerate(svc.replica_ids)}
    # on the CPU the interpreter lock serializes the flusher threads, and
    # a lane may sit out a short rehearsal's traffic; on a card every lane
    # must take flushes (the direct flushes below cover each lane anyway)
    idle_lane = device.type == 'cuda' and min(by_lane.values()) < 1
    if launches['traffic'] != kernel_launches(len(takes), device) or counts['fallback_flushes'] or \
            idle_lane or svc.compiled_shapes != warm_shapes:
        raise RuntimeError(f"{label}: {launches['traffic']} B1 launches for {len(takes)} flushes "
                           f'{by_lane}, {counts["fallback_flushes"]} fallback, shapes '
                           f'{svc.compiled_shapes} after {warm_shapes}')
    ref_gap = one_gap = 0.0
    for req, got, base in zip(reqs, res, one_res):
        if got.shape != (req.n, 3) or not np.isfinite(got).all():
            raise RuntimeError(f'{label}: a request came back {got.shape}, finite {np.isfinite(got).all()}')
        ref_gap = max(ref_gap, float(np.abs(got - reference_values(model, req, device)).max()))
        one_gap = max(one_gap, float(np.abs(got - base).max()))
    if not (ref_gap <= SERVE_ATOL and one_gap <= SERVE_ATOL):
        raise RuntimeError(f'{label}: requests {ref_gap} from rate_batch_reference, {one_gap} from '
                           f'the one-lane service (limit {SERVE_ATOL})')
    lane_traffic = {**traffic_record(reqs, walls, wall), 'flushes': len(takes), 'flushes_by_lane': by_lane,
                    'mean_requests_per_flush': n_total / len(takes), 'b1_launches': launches['traffic'],
                    'fallback_flushes': counts['fallback_flushes'], 'compiled_shapes': svc.compiled_shapes,
                    'max_abs_err_vs_reference': ref_gap, 'max_abs_err_vs_one_lane': one_gap,
                    'segment_mean_s': segments}
    one_traffic = {**traffic_record(reqs, one_walls, one_wall), 'flushes': len(one_takes),
                   'mean_requests_per_flush': n_total / len(one_takes), 'segment_mean_s': one_segments}
    print(f'{label}: (a) traffic through {L} lanes {json.dumps(lane_traffic)}; the same requests '
          f'through one lane {json.dumps(one_traffic)}; phase 16 one lane {json.dumps(one_lane)}')

    # one-request flushes: each request alone, so every lane flushes the
    # take the one-lane service flushes, at the same bucket; first through
    # the queue (whichever lane takes it), then on each lane in turn
    gm.fused_first_layer_quant.launches = 0
    n_takes = len(takes)
    bitwise = []
    for req in reqs[: sizes.single]:
        a = submit_request(one, req).result(timeout=300)
        b = submit_request(svc, req).result(timeout=300)
        bitwise.append(bool(np.array_equal(a, b)))
    single_lanes = sorted({lane for *_x, lane in takes[n_takes:]})
    per_lane, solo = [], []
    for i, req in enumerate(reqs[:L]):
        a = one._flush([serve_service._Payload(req.staging, req.gs, keep=(0, req.n))], 1)[0]
        solo.append(a)
        for lane in range(L):
            b = svc._flush([serve_service._Payload(req.staging, req.gs, keep=(0, req.n))], 1,
                           lane=lane)[0]
            per_lane.append(bool(np.array_equal(a, b)))
    launches['one-request flushes'] = b1()
    want = 2 * sizes.single + L * (L + 1)
    if not all(bitwise) or not all(per_lane) or \
            launches['one-request flushes'] != kernel_launches(want, device):
        raise RuntimeError(f'{label}: one-request flushes bitwise {bitwise}, on each lane '
                           f"{per_lane}, B1 {launches['one-request flushes']}")
    print(f'{label}: (a) one-request flushes {json.dumps({"through_the_queue": sizes.single, "lanes_taking_them": single_lanes, "on_each_lane": L * L, "bitwise_one_lane": all(bitwise) and all(per_lane), "b1": launches["one-request flushes"]})}')
    # a full flush alone on one lane against the one-lane service's: what a
    # lane's flush costs without the other lanes contending for the host
    top = ladder[-1]
    payloads = [serve_service._Payload(r.staging, r.gs, keep=(0, r.n)) for r in reqs[:top]]
    gm.fused_first_layer_quant.launches = 0
    alone = {'one_lane_s': synced_median(lambda: one._flush(payloads, top), device),
             'lane0_s': synced_median(lambda: svc._flush(payloads, top, lane=0), device)}
    launches['flush walls'] = b1()
    print(f'{label}: (a) one flush of {top} requests alone (synced medians) {json.dumps(alone)}')
    if device.type == 'cuda':
        # the card's busy and idle share under the same short traffic through
        # one lane and through the lanes (the profiler's view of each stream)
        gm.fused_first_layer_quant.launches = 0
        busy = {name: device_busy(lambda s=s: timed_clients(s, reqs[: 4 * sizes.clients], sizes.clients))
                for name, s in (('one_lane', one), ('lanes', svc))}
        launches['profiled traffic'] = b1()
        print(f'{label}: (a) {4 * sizes.clients} requests under the profiler {json.dumps(busy)}')
    one.close()

    # -- (c) the frontend: GET /health over a unix socket is health()
    sock = os.path.join(LANES_DIR, 'frontend.sock')
    with ServingFrontend(svc, unix_path=sock):
        got = FrontendClient(sock).health()
        want = json.loads(json.dumps(svc.health(), sort_keys=True, default=str))
    for h in (got, want):
        for key in ('uptime_s', 'last_flush_age_s'):
            h.pop(key)
    if got != want or got['replicas']['n'] != L:
        raise RuntimeError(f'{label}: GET /health differs from health(): '
                           f'{sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))}')
    print(f'{label}: (c) frontend GET /health equals health() {json.dumps({"keys": len(got), "status": got["status"], "replicas": got["replicas"]["n"], "sick": got["replicas"]["sick"]})}')
    svc.close()

    # -- a sick lane, and B1 that cannot load on one lane's stream
    drill = RatingService(model, n_replicas=L, breaker_failures=2, breaker_recovery_s=3600.0, **shape)
    drill.warmup()
    sick, rid = 2, drill.replica_ids[2]
    for _ in range(2):
        drill.breakers[sick].record_failure(RuntimeError('induced device fault'))
    health = drill.health()
    if health['status'] != 'degraded' or health['replicas']['sick'] != [rid]:
        raise RuntimeError(f'{label}: after tripping {rid}: {health["status"]}, {health["replicas"]}')
    dreqs = reqs[: sizes.drill_requests]
    drefs = [reference_values(model, r, device) for r in dreqs]
    fb0 = lane_fallbacks(drill)
    dtakes = count_lane_takes(drill)
    gm.fused_first_layer_quant.launches = 0
    served, rounds, gap = False, 0, 0.0
    deadline = time.monotonic() + 60.0
    while not served and time.monotonic() < deadline:
        rounds += 1
        out, _w, _t = timed_clients(drill, dreqs, 4)
        gap = max([gap] + [float(np.abs(o - r).max()) for o, r in zip(out, drefs)])
        served = lane_fallbacks(drill)[rid] > fb0[rid]
    sync(device)
    launches['sick lane'] = b1()
    fb = delta(lane_fallbacks(drill), fb0)
    fused_flushes = sum(1 for *_x, lane in dtakes if lane != sick)
    if not served or gap > SERVE_ATOL or any(v for r, v in fb.items() if r != rid) or \
            launches['sick lane'] != kernel_launches(fused_flushes, device):
        raise RuntimeError(f'{label}: sick lane served {served} in {rounds} rounds, {gap} off, '
                           f"fallbacks {fb}, B1 {launches['sick lane']} for {fused_flushes} fused flushes")
    print(f'{label}: (a) sick lane {json.dumps({"sick": health["replicas"]["sick"], "status": health["status"], "rounds": rounds, "fallback_flushes_by_lane": fb, "fused_flushes": fused_flushes, "b1": launches["sick lane"], "max_abs_err_vs_reference": gap})}')

    fault_lane = 1
    payloads = [serve_service._Payload(r.staging, r.gs, keep=(0, r.n)) for r in reqs[:1]]
    def breaker_states() -> List[Dict[str, Any]]:
        # the open lane's dwell is a clock reading
        return [{k: v for k, v in b.to_dict().items() if k != 'open_for_s'} for b in drill.breakers]

    breakers = breaker_states()
    fb0 = lane_fallbacks(drill)
    dispatcher = drill._dispatcher_for(model)
    gm.fused_first_layer_quant.launches = 0
    if device.type == 'cuda':
        # the library load fails as dlopen would, on lane 1's stream only
        real_load = cuda_build.load_library
        lane_stream = drill._lane_streams[fault_lane]

        def load(name: str) -> Any:
            if torch.cuda.current_stream(device) == lane_stream:
                raise OSError(f'lib{name}.so: cannot open shared object file (lane fault drill)')
            return real_load(name)

        patched: Tuple[Any, str, Any] = (cuda_build, 'load_library', load)
    else:
        # the CPU's wrapper loads nothing: lane 1's dispatch raises instead
        real_dispatch = dispatcher.dispatch

        def dispatch(replica: int, batch: Any, overrides: Any = None) -> Any:
            if replica == fault_lane:
                raise cuda_build.KernelError('gather_matmul cannot be loaded (lane fault drill)')
            return real_dispatch(replica, batch, overrides)

        patched = (dispatcher, 'dispatch', dispatch)
    original = getattr(patched[0], patched[1])
    setattr(patched[0], patched[1], patched[2])
    try:
        try:
            drill._flush(payloads, 1, lane=fault_lane)
            raised = None
        except cuda_build.KernelError as e:
            raised = str(e)
        other = drill._flush(payloads, 1, lane=0)[0]
    finally:
        setattr(patched[0], patched[1], original)
    again = drill._flush(payloads, 1, lane=fault_lane)[0]
    launches['kernel-fault drill'] = b1()
    unmoved = breaker_states() == breakers
    fb = delta(lane_fallbacks(drill), fb0)
    base = solo[0]  # the one-lane service's one-request flush of reqs[0]
    if raised is None or not unmoved or any(fb.values()) or not np.array_equal(other, base) or \
            not np.array_equal(again, base) or launches['kernel-fault drill'] != kernel_launches(2, device):
        raise RuntimeError(f'{label}: lane kernel-fault drill: raised {raised}, breakers unmoved '
                           f"{unmoved}, fallbacks {fb}, B1 {launches['kernel-fault drill']}")
    drill.close()
    print(f'{label}: (a) kernel fault on lane {fault_lane} {json.dumps({"flush_raised": raised, "breakers_unmoved": unmoved, "fallback_flushes": fb, "lane0_bitwise_one_lane": True, "lane1_after_restore_bitwise": True, "b1": launches["kernel-fault drill"]})}')

    # -- a swap lands on every lane or on none
    registry = ModelRegistry(os.path.join(LANES_DIR, 'registry'), device=device)
    registry.publish('vaep', '1', model)
    registry.publish('vaep', '2', make_model(device, sizes.hidden, head_seed=200))
    registry.activate('vaep', '1')
    versions = {v: registry.load('vaep', v) for v in ('1', '2')}
    sreqs = reqs[: 2 * L]
    srefs = {v: [reference_values(m, r, device) for r in sreqs] for v, m in versions.items()}

    def rated_by(outs: List[np.ndarray]) -> List[str]:
        found = []
        for i, got in enumerate(outs):
            gaps = {v: float(np.abs(got - srefs[v][i]).max()) for v in srefs}
            match = [v for v, g in gaps.items() if g <= SERVE_ATOL]
            if len(match) != 1 or min(gaps.values()) > SERVE_ATOL or max(gaps.values()) <= SERVE_APART:
                raise RuntimeError(f'{label}: a request is not wholly one version: {gaps}')
            found.append(match[0])
        return found

    wsvc = RatingService(registry=registry, n_replicas=L, **shape)
    gm.fused_first_layer_quant.launches = 0
    wsvc.warmup()
    k = len(wsvc.ladder) + 2  # lane 0 warms on calls 1..len(ladder), lane 1 next
    with FaultPlan(seed=17, specs=[FaultSpec('serve.dispatch', error=RuntimeError, on_calls=(k,))]) as plan:
        try:
            wsvc.swap_model('vaep', '2')
            swap_error = None
        except RuntimeError as e:
            swap_error = str(e)
    points = [h['point'] for h in plan.history]
    during = rated_by(timed_clients(wsvc, sreqs, L)[0])
    version_during = wsvc.health()['model']['version']
    t0 = time.perf_counter()
    wsvc.swap_model('vaep', '2')
    swap_s = time.perf_counter() - t0
    swapped = rated_by(timed_clients(wsvc, sreqs, L)[0])
    launches['swap'] = b1()
    wsvc.close()
    if swap_error is None or points != ['serve.dispatch'] or set(during) != {'1'} or \
            version_during != '1' or set(swapped) != {'2'}:
        raise RuntimeError(f'{label}: swap drill: failed swap {swap_error} at {points}, during '
                           f'{during} ({version_during}), after {swapped}')
    print(f'{label}: (a) swap {json.dumps({"failed_swap": swap_error, "served_during": sorted(set(during)), "version_during": version_during, "served_after": sorted(set(swapped)), "swap_wall_s": swap_s, "b1": launches["swap"]})}')

    # -- (b) the warm tier: shipped libraries in a fresh process
    root = os.path.abspath(os.path.join(LANES_DIR, 'aot'))
    os.makedirs(root)
    aot = {'ladder': list(ladder), 'max_actions': A}
    publish = contextlib.nullcontext()
    if device.type == 'cpu':
        stand_in_libraries(os.path.join(root, 'publisher-cache'))
        publish = compile_cache(os.path.join(root, 'publisher-cache'))
    areg = ModelRegistry(os.path.join(root, 'registry'), device=device)
    with publish:
        t0 = time.perf_counter()
        areg.publish('vaep', '1', model, aot=aot)
        publish_s = time.perf_counter() - t0
        areg.publish('vaep', '2', model, aot=aot)
    manifest = read_manifest(areg.aot_dir('vaep', '1'))
    if [e['id'] for e in manifest['entries']] != list(KERNELS) or \
            manifest['fingerprint'] != env_fingerprint(device):
        raise RuntimeError(f'{label}: the shipped manifest {manifest}')
    stale_path = os.path.join(areg.aot_dir('vaep', '2'), 'manifest.json')
    with open(stale_path, encoding='utf-8') as fh:
        stale_manifest = json.load(fh)
    stale_manifest['fingerprint'].update(cuda='0.0-elsewhere', device_kind='another card')
    write_json(stale_path, stale_manifest)
    req = serve_request(rng, A, A)
    np.savez(os.path.join(root, 'request.npz'), gs=req.gs, n=req.n,
             **{f'f_{k}': v for k, v in req.staging.fields().items()})
    write_json(os.path.join(root, 'spec.json'), {'shape': shape})
    # this process's values of the same request, from the version read back
    preg = ModelRegistry(os.path.join(root, 'registry'), device=device)
    preg.activate('vaep', '1')
    with RatingService(registry=preg, **shape) as psvc:
        gm.fused_first_layer_quant.launches = 0
        parent_values = submit_request(psvc, req).result(timeout=300)
        launches['warm-tier parent'] = b1()
    outcomes = {'1': 'hit', '2': 'stale'}
    children = {outcomes[v]: rep for v, rep in spawn_aot_replicas(root, tuple(outcomes), device).items()}
    for outcome, rep in children.items():
        launches[f'{outcome} child'] = int(rep['b1_launches'])
        on_card = device.type == 'cuda'
        want_builds = 0 if outcome == 'hit' or not on_card else len(KERNELS)
        in_cache = all(p.startswith(rep['cache']) for p in rep['library_paths'].values())
        ok = (rep['aot']['outcome'] == outcome and rep['compile_cache'] == rep['cache']
              and rep['kernel_builds'] == want_builds
              and np.array_equal(rep['values'], parent_values)
              and rep['b1_launches'] == kernel_launches(1, device)
              and (not on_card or (in_cache and len(rep['library_paths']) == len(KERNELS))))
        if outcome == 'hit':
            ok = ok and rep['aot']['entries_loaded'] == len(KERNELS) and \
                rep['aot_loads']['hit'] == len(KERNELS) and all(rep['installed'].values())
        else:
            ok = ok and set(rep['aot']['mismatch']) == {'cuda', 'device_kind'} and \
                rep['aot_loads']['stale'] == 1 and (on_card or not any(rep['installed'].values()))
        if not ok:
            raise RuntimeError(f'{label}: the {outcome} child: {json.dumps({k: v for k, v in rep.items() if k != "values"}, default=str)}')
    walls = {outcome: {'phase_seconds': rep['coldstart']['phase_seconds'],
                       'wall_s': rep['coldstart'].get('wall_s'),
                       'unattributed_s': rep['coldstart'].get('unattributed_s'),
                       'spawn_wall_s': rep['spawn_wall_s'], 'aot': rep['aot'],
                       'aot_loads': rep['aot_loads'], 'kernel_builds': rep['kernel_builds'],
                       'build_seconds': rep['build_seconds'], 'b1': rep['b1_launches'],
                       'bitwise_parent': True}
             for outcome, rep in children.items()}
    print(f'{label}: (b) warm tier {json.dumps({"publish_with_aot_s": publish_s, "entries": [{k: e[k] for k in ("id", "nbytes", "digest")} for e in manifest["entries"]], "fingerprint": manifest["fingerprint"]})}')
    for outcome, rec in walls.items():
        print(f'{label}: (b) {outcome} child cold start {json.dumps(rec, default=str)}')
    shutil.rmtree(LANES_DIR, ignore_errors=True)
    print(f'{label}: B1 launches {json.dumps(launches)}; phase 17 in {time.perf_counter() - t_phase:.1f} s')
    return launches

# -- phase 18: the device work under the DataFrame layer -------------------------------------


class FrameSizes(NamedTuple):
    """Phase 18's shapes: the serving batch for (a) and (b), the parity
    batch for (c), and the MLP learner's parameters of each."""

    games: int = GAMES
    actions: int = ACTIONS
    parity_games: int = PARITY_GAMES
    params: Dict[str, Any] = TRAIN_PARAMS
    parity_params: Dict[str, Any] = PARITY_PARAMS


def frame_fit(batch: ActionBatch, params: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """``VAEP.fit(X, y, learner='mlp')`` without the frames, on ``device``:
    the host rows ``compute_features``/``compute_labels`` put in their
    frames (:meth:`VAEP.features_rows`, :meth:`VAEP.labels_rows`), then
    :meth:`VAEP.fit_rows`, the code ``fit`` runs once it has selected its
    columns (the split at ``val_size=0.25``, ``random_state=0``, and one
    ``LEARNERS['mlp']`` call per label). Both kernels' counts are zeroed
    just before and read just after; synchronized walls and the bytes
    each way."""
    dev = batch.device
    model = VAEP(device=device)
    cells = batch.n_games * batch.max_actions
    n_features = train_layout(model.xfns, model.nb_prev_actions, model._registry).n_features
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    X, y = model.features_rows(batch), model.labels_rows(batch)
    rows_s = time.perf_counter() - t0
    train_rows, val_rows = model.fit_rows(
        X, y, learner='mlp', val_size=0.25, tree_params=params, random_state=0
    )
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'gather_matmul': gm.fused_first_layer_quant.launches,
                'segment_sum': seg.segment_sum.launches}
    n = batch.total_actions
    if X.shape != (n, n_features) or X.dtype != np.float32 or not np.isfinite(X).all():
        raise RuntimeError(f'feature rows have shape {X.shape}, {X.dtype}, not ({n}, {n_features}) finite f32')
    if sorted(y) != ['concedes', 'scores'] or any(v.dtype != bool or v.shape != (n,) for v in y.values()):
        raise RuntimeError('label rows are not one bool column per label')
    heads = {}
    for col, clf in model._models.items():
        health = clf.train_health_
        if not (health['finite'] and health['path'] == 'materialized'):
            raise RuntimeError(f'head {col!r} of the frame fit trained to {health}')
        heads[col] = {k: health[k] for k in ('epochs', 'epoch_losses', 'val_losses', 'epoch_seconds')}
    return {
        'model': model, 'batch': batch, 'split': (train_rows, val_rows), 'wall_s': wall,
        'rows_s': rows_s, 'launches': launches, 'heads': heads,
        # the padded feature tensor and both label tensors, each with the
        # batch's mask and row order, to the host; X and y of both splits
        # to the device once per head
        'bytes_to_host': cells * (4 * n_features + 2)
        + 3 * cells * (batch.mask.element_size() + batch.row_index.element_size()),
        'bytes_to_device': len(model._models) * 4 * (len(train_rows) + len(val_rows)) * (n_features + 1),
    }


def compare_frame_fits(card: Dict[str, Any], cpu: Dict[str, Any]) -> Dict[str, Any]:
    """Hold the card's frame fit to the CPU's; raise on any miss: the
    split equal, the statistics as :func:`compare_training` holds them (std
    within rtol 1e-6, the mean within 1e-6 of max(|mean|, std)), every
    parameter within 1e-4."""
    for a, b in zip(card['split'], cpu['split']):
        if not np.array_equal(a, b):
            raise RuntimeError('the card and the CPU split the frame rows differently')
    report: Dict[str, Any] = {'split_equal': True}
    for col in card['model']._models:
        ha, hb = card['model']._models[col], cpu['model']._models[col]
        mean_a, mean_b = _np(ha.mean_).astype(np.float64), _np(hb.mean_).astype(np.float64)
        std_a, std_b = _np(ha.std_).astype(np.float64), _np(hb.std_).astype(np.float64)
        std_rel = float((np.abs(std_a - std_b) / std_b).max())
        mean_rel = float((np.abs(mean_a - mean_b) / np.maximum(np.abs(mean_b), std_b)).max())
        gap = max_param_gap(card['model'], cpu['model'], col)
        report[col] = {'std_rel': std_rel, 'mean_rel': mean_rel, 'param_gap': gap}
        if not (std_rel <= 1e-6 and mean_rel <= 1e-6 and gap <= 1e-4):
            raise RuntimeError(f'{col}: the frame fits differ between the card and the CPU: {report[col]}')
    return report


def xt_oracle_check(fit: Dict[str, Any]) -> Dict[str, Any]:
    """The numpy value iteration of ``ExpectedThreat(backend='pandas')``
    over a device fit's probability matrices (phase 5's 16 x 12 card fit):
    its grid within 1e-5 of the fit's, its sweeps within one."""
    probs = fit['probs']
    w, l = fit['grid'].shape
    oracle = ExpectedThreat(l=l, w=w, backend='pandas')
    oracle.scoring_prob_matrix = probs['p_score']
    oracle.shot_prob_matrix = probs['p_shot']
    oracle.move_prob_matrix = probs['p_move']
    oracle.transition_matrix = probs['transition']
    t0 = time.perf_counter()
    oracle._solve_numpy()
    solve_s = time.perf_counter() - t0
    err = float(np.abs(oracle.xT - fit['grid']).max())
    gap = abs(oracle.n_iter - int(fit['iterations']))
    if not (oracle.converged and err <= 1e-5 and gap <= 1):
        raise RuntimeError(f'the numpy oracle is {err} from the device grid, {gap} sweeps apart')
    return {'grid_max_abs_err': err, 'iterations': oracle.n_iter,
            'device_iterations': int(fit['iterations']), 'numpy_solve_s': solve_s}


def frame_phase(
    device: torch.device, xt_fit: Dict[str, Any], card: str = 'CPU',
    fit_packed_wall_s: Optional[float] = None, sizes: FrameSizes = FrameSizes(),
) -> Dict[str, Any]:
    """Phase 18, the device work under the DataFrame layer; the card's
    machine has no pandas, so it enters where ``fit`` and
    ``compute_features`` hand arrays on.

    (a) The seeded standard batch's feature and label rows computed on
    ``device`` and unpacked as ``compute_features``/``compute_labels`` fill
    their frames, then ``fit``'s remainder with (128, 128) MLP heads,
    batches of 8192, 3 epochs, trained on ``device``; its wall beside
    phase 6's ``fit_packed``'s. (b) The fitted model's ``rate_batch`` on
    the fused path: B1 once, within 1e-5 of ``rate_batch_reference``, and
    B1 held to its plain version on the operands the call hands it. (c)
    The remainder on the parity batch on ``device`` and on the CPU (lr
    1e-4, 2 epochs), held together. (d) The pandas backend's numpy value
    iteration over phase 5's card fit's matrices.
    """
    label = 'frame path'
    t_phase = time.perf_counter()
    batch = synthetic_batch(sizes.games, sizes.actions, seed=0, device=device)
    run = frame_fit(batch, sizes.params, device)
    print(
        f"{label} (a): compute_features/compute_labels rows and fit_rows(learner='mlp') on "
        f'{batch.total_actions} actions ({len(run["split"][0])} training rows, '
        f'{json.dumps(sizes.params)}): {run["wall_s"]:.3f} s synced, {run["rows_s"]:.3f} s of it '
        f'the rows; phase 6 fit_packed on the same shape: {fit_packed_wall_s} s; bytes to the '
        f'host {run["bytes_to_host"]}, to the device {run["bytes_to_device"]}; launches '
        f'{json.dumps(run["launches"])} ({card})'
    )
    for col, head in run['heads'].items():
        print(f'{label} (a): head {col}: {json.dumps(head)}')
        if not head['epoch_losses'][-1] < head['epoch_losses'][0]:
            raise RuntimeError(f"{label}: head {col!r}'s training loss did not fall: {head}")
    model, fit_launches = run['model'], run['launches']
    gm.fused_first_layer_quant.launches = 0
    values = model.rate_batch(batch)
    sync(device)
    launches = gm.fused_first_layer_quant.launches
    if model._rating_path() != 'fused' or launches != (1 if device.type == 'cuda' else 0):
        raise RuntimeError(f'{label}: rate_batch took {model._rating_path()!r}, B1 launched {launches} times')
    print(f'{label} (b): rate_batch {tuple(values.shape)} on the fused path, B1 launches {launches}')
    err = check_against_reference(model, batch, values, f'{label} (b): the fitted model')
    b1 = None
    if device.type == 'cuda':
        b1 = check_first_layer(device, torch.float32, ops=first_layer_operands_of(model, batch))
        print(f"kernel gather_matmul on {label}'s operands vs plain ({card}): {json.dumps(b1)}")
    del model, values, batch, run
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    pbatch = synthetic_batch(sizes.parity_games, sizes.actions, seed=5, device=device)
    card_run = frame_fit(pbatch, sizes.parity_params, device)
    t0 = time.perf_counter()
    cpu_run = frame_fit(pbatch.to('cpu'), sizes.parity_params, 'cpu')
    cpu_s = time.perf_counter() - t0
    parity = compare_frame_fits(card_run, cpu_run)
    print(
        f'{label} (c): fit_rows on {pbatch.n_games} games, {device.type} against the CPU '
        f'({cpu_s:.1f} s, plain versions), {json.dumps(sizes.parity_params)}: {json.dumps(parity)}'
    )
    del pbatch, card_run, cpu_run
    oracle = xt_oracle_check(xt_fit)
    print(f"{label} (d): ExpectedThreat(backend='pandas') value iteration over phase 5's "
          f'{device.type} fit matrices: {json.dumps(oracle)}')
    print(f'{label}: phase 18 in {time.perf_counter() - t_phase:.1f} s')
    return {'fit_launches': fit_launches, 'rate_launches': launches, 'rate_err': err, 'b1': b1,
            'parity': parity, 'oracle': oracle}


# -- phase 19: the synthetic quality tier -------------------------------------------------

#: sha256 of the quality tier's season (:func:`season_digest`): the chain
#: generator's columns of games 7000 to 7047, seeds 0 to 47, home 100, away
#: 200, 1000 actions each; the JAX package's frames hash to it too.
SEASON_DIGEST = '183f6b6b54e4b2e2c4477f7da5a1a6ba72ee2b2b5a7bc00304dff0dfa6195f58'
#: The quality tier's floors: held-out AUROC above, Brier below, and the
#: shuffled-label control's AUROC below (``tests/test_quality_synthetic.py``).
QUALITY_AUROC_FLOOR = 0.78
QUALITY_BRIER_CEILING = 0.06
QUALITY_CONTROL_CEILING = 0.58
#: ``QUALITY.md``'s held-out numbers of the JAX package's MLP on this season.
JAX_MLP_QUALITY = {'scores': {'auroc': 0.823, 'brier': 0.0347},
                   'concedes': {'auroc': 0.847, 'brier': 0.0126}}
QUALITY_HOME, QUALITY_AWAY = 100, 200


class QualitySizes(NamedTuple):
    """Phase 19's season (games ``7000 + i`` drawn with seed ``i``: the
    first ``train_games`` to fit, the rest held out), the MLP learner's
    parameters, and whether the tier's digest and floors hold (off for a
    rehearsal at a tiny size)."""

    train_games: int = 36
    test_games: int = 12
    actions: int = 1000
    params: Dict[str, Any] = {'batch_size': 2048, 'max_epochs': 100, 'patience': 10}
    digest: Optional[str] = SEASON_DIGEST
    floors: bool = True


def chain_season(sizes: QualitySizes) -> List[Dict[str, np.ndarray]]:
    """The tier's games as the chain generator's columns, in game order."""
    return [
        _chain_columns(7000 + i, home_team_id=QUALITY_HOME, away_team_id=QUALITY_AWAY,
                       n_actions=sizes.actions, seed=i)
        for i in range(sizes.train_games + sizes.test_games)
    ]


def season_digest(games: List[Dict[str, np.ndarray]]) -> str:
    """sha256 over each game's ``CHAIN_COLUMNS``, in order: name, dtype,
    shape and bytes."""
    h = hashlib.sha256()
    for cols in games:
        for c in CHAIN_COLUMNS:
            a = np.ascontiguousarray(cols[c])
            h.update(f'{c}:{a.dtype.str}:{a.shape}'.encode())
            h.update(a.tobytes())
    return h.hexdigest()


def pack_chain_games(games: List[Dict[str, np.ndarray]], home_team_id: Any, device: DeviceLike) -> ActionBatch:
    """``pack_actions`` of the games' frames, from the columns (no pandas):
    left-aligned, padded to the lane multiple. ``home_team_id`` is one home
    team for every game, or a list of one a game."""
    lengths = [len(cols['game_id']) for cols in games]
    G, A = len(games), pad_length(max(lengths))
    homes = home_team_id if isinstance(home_team_id, (list, tuple)) else [home_team_id] * G
    mask = np.arange(A)[None, :] < np.asarray(lengths)[:, None]

    def grid(values: List[np.ndarray], dtype: Any, fill: Any = 0) -> np.ndarray:
        out = np.full((G, A), fill, dtype=dtype)
        out[mask] = np.concatenate(values).astype(dtype)
        return out

    cols = {c: grid([g[c] for g in games], np.float32)
            for c in ('time_seconds', 'start_x', 'start_y', 'end_x', 'end_y')}
    cols.update({c: grid([g[c] for g in games], np.int32)
                 for c in ('type_id', 'result_id', 'bodypart_id', 'period_id')})
    cols['is_home'] = grid([g['team_id'] == home for g, home in zip(games, homes)], bool, False)
    cols['mask'] = mask
    cols['n_actions'] = np.asarray(lengths, dtype=np.int32)
    cols['game_id'] = np.arange(G, dtype=np.int32)
    cols['row_index'] = grid([np.arange(sum(lengths), dtype=np.int32)], np.int32, -1)
    return _from_numpy(cols, resolve_device(device))


def auroc(y: np.ndarray, p: np.ndarray) -> float:
    """ROC AUC from ranks, ties averaged (``roc_auc_score``'s value)."""
    y = np.asarray(y, dtype=bool)
    p = np.asarray(p, dtype=np.float64)
    order = np.argsort(p, kind='mergesort')
    _, first, counts = np.unique(p[order], return_index=True, return_counts=True)
    ranks = np.empty(len(p))
    ranks[order] = np.repeat(first + (counts + 1) / 2.0, counts)
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float('nan')  # one class only: no ranking to score
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def brier(y: np.ndarray, p: np.ndarray) -> float:
    """Mean squared gap between the probabilities and the 0/1 labels."""
    return float(np.mean((np.asarray(p, dtype=np.float64) - np.asarray(y, dtype=np.float64)) ** 2))


def quality_fit(
    device: torch.device, X: np.ndarray, y: Dict[str, np.ndarray], params: Dict[str, Any],
    random_state: int,
) -> Dict[str, Any]:
    """``VAEP.fit(X, y, learner='mlp')``'s remainder on the rows, on
    ``device``, with both kernels' counts zeroed just before and read just
    after; the synchronized wall and each head's epochs."""
    model = VAEP(device=device)
    sync(device)
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    model.fit_rows(X, y, learner='mlp', val_size=0.25, tree_params=params, random_state=random_state)
    sync(device)
    wall = time.perf_counter() - t0
    heads = {}
    for col, clf in model._models.items():
        health = clf.train_health_
        if not health['finite']:
            raise RuntimeError(f'quality head {col!r} trained to {health}')
        heads[col] = {'epochs': health['epochs'], 'last_loss': health['epoch_losses'][-1],
                      'best_val_loss': min(health['val_losses']) if health['val_losses'] else None}
    return {'model': model, 'wall_s': wall, 'heads': heads,
            'launches': {'gather_matmul': gm.fused_first_layer_quant.launches,
                         'segment_sum': seg.segment_sum.launches}}


def held_out_scores(model: VAEP, batch: ActionBatch, y: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Each head's probabilities of the held-out rows through B1
    (``predict_proba_device_batch``: one launch a head on the card), their
    AUROC and Brier; B1's launches counted over the calls, the operands of
    the first captured, and the probabilities against the plain path (the
    feature tensor through the head)."""
    dev = batch.device
    sync(dev)
    gm.fused_first_layer_quant.launches = 0
    probs = {}
    # fused_mlp_logits enters B1 through fused_first_layer (same operands)
    with captured(fused_ops, 'fused_first_layer', first_only=True) as calls:
        for col, clf in model._models.items():
            probs[col] = clf.predict_proba_device_batch(batch, names=model.xfns, k=model.nb_prev_actions)
    sync(dev)
    launches = gm.fused_first_layer_quant.launches
    if not calls:
        raise RuntimeError('the held-out scores handed B1 no operands')
    feats = model.compute_features_batch(batch)
    plain_gap = max(float((probs[col] - clf.predict_proba_device(feats)).abs()[batch.mask].max())
                    for col, clf in model._models.items())
    if plain_gap > 1e-5:
        raise RuntimeError(f'held-out probabilities through B1 are {plain_gap} from the plain path')
    metrics = {}
    for col, p in probs.items():
        flat = p[batch.mask].cpu().numpy()
        metrics[col] = {'auroc': auroc(y[col], flat), 'brier': brier(y[col], flat)}
    return {'metrics': metrics, 'launches': launches, 'plain_gap': plain_gap, 'operands': calls[0][0]}


def quality_phase(device: torch.device, card: str = 'CPU', sizes: QualitySizes = QualitySizes()) -> Dict[str, Any]:
    """Phase 19, the JAX package's synthetic quality tier on ``device``.

    (a) The tier's season drawn with the chain generator's pandas-free
    core, timed on the host, its columns' sha256 held to
    :data:`SEASON_DIGEST`. (b) Feature and label rows (k = 3) of the
    training games on ``device`` and ``fit_rows(learner='mlp')`` with the
    tier's parameters and ``random_state=0``. (c) Both heads' held-out
    probabilities through B1, their AUROC and Brier held to the tier's
    floors; the shuffled-label control (a per-column permutation from
    ``default_rng(0)``, ``random_state=1``) held below its ceiling; B1
    against its plain version on the held-out operands.
    """
    label = 'quality tier'
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    season = chain_season(sizes)
    draw_s = time.perf_counter() - t0
    digest = season_digest(season)
    n_games = len(season)
    print(f'{label} (a): {n_games} chain games of {sizes.actions} actions drawn in {draw_s:.3f} s '
          f'on the host ({draw_s / n_games * 1e3:.1f} ms a game); sha256 {digest}')
    if sizes.digest is not None and digest != sizes.digest:
        raise RuntimeError(f'{label}: the season hashes to {digest}, not {sizes.digest}')
    train = pack_chain_games(season[:sizes.train_games], QUALITY_HOME, device)
    test = pack_chain_games(season[sizes.train_games:], QUALITY_HOME, device)
    del season

    rows = VAEP(device=device)
    t0 = time.perf_counter()
    X, y = rows.features_rows(train), rows.labels_rows(train)
    rows_s = time.perf_counter() - t0
    fit = quality_fit(device, X, y, sizes.params, random_state=0)
    print(f"{label} (b): features_rows/labels_rows of {len(X)} training actions in {rows_s:.3f} s, "
          f"fit_rows(learner='mlp', {json.dumps(sizes.params)}, random_state=0) in "
          f"{fit['wall_s']:.3f} s synced; heads {json.dumps(fit['heads'])}; launches "
          f"{json.dumps(fit['launches'])} ({card})")

    y_test = rows.labels_rows(test)
    scored = held_out_scores(fit['model'], test, y_test)
    want = kernel_launches(len(fit['model']._models), device)
    if scored['launches'] != want:
        raise RuntimeError(f"{label}: the held-out scores launched B1 {scored['launches']} times, not {want}")
    print(f"{label} (c): held-out {test.total_actions} actions through B1 "
          f"({scored['launches']} launches, {scored['plain_gap']:.3g} from the plain path): "
          f"{json.dumps(scored['metrics'])}; JAX MLP (QUALITY.md): {json.dumps(JAX_MLP_QUALITY)}")

    rng = np.random.default_rng(0)
    shuffled = {col: rng.permutation(y[col]) for col in ('scores', 'concedes')}
    control = quality_fit(device, X, shuffled, sizes.params, random_state=1)
    control_scored = held_out_scores(control['model'], test, y_test)
    if control_scored['launches'] != want:
        raise RuntimeError(f"{label}: the control's scores launched B1 {control_scored['launches']} times")
    print(f"{label} (c): shuffled-label control in {control['wall_s']:.3f} s, heads "
          f"{json.dumps(control['heads'])}: {json.dumps(control_scored['metrics'])}")
    if sizes.floors:
        for col, m in scored['metrics'].items():
            if not (m['auroc'] > QUALITY_AUROC_FLOOR and m['brier'] < QUALITY_BRIER_CEILING):
                raise RuntimeError(f'{label}: head {col!r} held out at {m}')
        for col, m in control_scored['metrics'].items():
            if not m['auroc'] < QUALITY_CONTROL_CEILING:
                raise RuntimeError(f'{label}: the shuffled control head {col!r} reached {m}')

    b1 = None
    if device.type == 'cuda':
        b1 = check_first_layer(device, torch.float32, ops=scored['operands'])
        print(f"kernel gather_matmul on {label}'s held-out operands vs plain ({card}): {json.dumps(b1)}")
    wall = time.perf_counter() - t_phase
    print(f'{label}: phase 19 in {wall:.1f} s')
    return {
        'digest': digest, 'draw_s': draw_s, 'fit_wall_s': fit['wall_s'], 'heads': fit['heads'],
        'metrics': scored['metrics'], 'control': control_scored['metrics'],
        'launches': scored['launches'] + control_scored['launches'],
        'fit_launches': {k: fit['launches'][k] + control['launches'][k] for k in fit['launches']},
        'b1': b1, 'wall_s': wall,
    }



# -- phase 20: the providers' loaders ------------------------------------------------------

#: The provider fixture feeds, and the SPADL actions of their games
#: (``tests/datasets/port/make_provider_spadl.py`` writes that file).
DATASETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests', 'datasets')
PROVIDER_SPADL = os.path.join(DATASETS, 'port', 'provider_spadl.json')
#: Phase 20 (b): each parser the card's machine runs (none reads XML, so
#: none needs lxml), the fixture file it reads and the ids ``OptaLoader``
#: gives it from the file's name.
PROVIDER_PARSERS = (
    ('F1JSONParser', 'opta/tournament-2017-8.json', {'competition_id': 8, 'season_id': 2017}),
    ('F9JSONParser', 'opta/f7-8-2017-501.json', {'competition_id': 8, 'season_id': 2017, 'game_id': 501}),
    ('F24JSONParser', 'opta/f7-8-2017-501.json', {'competition_id': 8, 'season_id': 2017, 'game_id': 501}),
    ('MA1JSONParser', 'statsperform/ma1-8-2017.json', {'competition_id': 8, 'season_id': 2017}),
    ('MA3JSONParser', 'statsperform/ma3-8-2017-501.json',
     {'competition_id': 8, 'season_id': 2017, 'game_id': 501}),
    ('WhoScoredParser', 'whoscored/8-2017-501.json', {'competition_id': 8, 'season_id': 2017, 'game_id': 501}),
)
#: The ``extract_*`` methods that build DataFrames (the card's machine has no pandas).
PANDAS_EXTRACTS = {'MA3JSONParser': ('extract_players',)}
#: sha256 of each parser's records (:func:`provider_digest`); the JAX
#: package's parsers give the same.
PROVIDER_DIGESTS = {
    'F1JSONParser': '6775601e4a5e87306d64c56827886ff17b6834e84921d1b3c8db45a35017265e',
    'F9JSONParser': '6d252163fde978cb81fcfa94fa3a4c33dfec6867444d46041e8d7103087f7290',
    'F24JSONParser': 'b84dffa09c341a8858acc0f594a82711a0e248c6818f804acd9e433c4ad09380',
    'MA1JSONParser': 'ab7b6c2d6f0e3ade4c78f2aba134592ed4c0900e8e278a073f73e4ed9d47d6ae',
    'MA3JSONParser': '4d5a1148cbe74f8c072db762474dd1904a2ceef27400f63caaaf38834cfad33b',
    'WhoScoredParser': '25084edc4e510ce4aa9276c0b3114f446105a84ed947c135808a9fe7e4727680',
}
#: The SPADL actions of each layout's game, as the JAX package's loaders
#: and converters give them.
PROVIDER_ACTIONS = {'opta_xml': 10, 'opta_json': 10, 'statsperform': 10, 'whoscored': 10,
                    'wyscout_public': 17, 'wyscout_api': 5}


def provider_imports() -> Dict[str, Any]:
    """Phase 20 (a): import the Wyscout and Opta packages and every parser
    module, resolve the deprecated loader names of ``spadl.opta`` and
    ``spadl.wyscout`` (each the port's class, with a ``DeprecationWarning``);
    raise if pandas or lxml got loaded."""
    import importlib
    import pkgutil
    import warnings

    wyscout = importlib.import_module('socceraction_tpu_torch.data.wyscout')
    opta = importlib.import_module('socceraction_tpu_torch.data.opta')
    parsers = importlib.import_module('socceraction_tpu_torch.data.opta.parsers')
    modules = [wyscout.__name__, opta.__name__, parsers.__name__]
    for info in pkgutil.walk_packages(parsers.__path__, parsers.__name__ + '.'):
        modules.append(importlib.import_module(info.name).__name__)
    resolved = {}
    for provider, name, want in (('opta', 'OptaLoader', opta.OptaLoader),
                                 ('wyscout', 'WyscoutLoader', wyscout.WyscoutLoader),
                                 ('wyscout', 'PublicWyscoutLoader', wyscout.PublicWyscoutLoader)):
        spadl = importlib.import_module(f'socceraction_tpu_torch.spadl.{provider}')
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            got = getattr(spadl, name)
        if got is not want:
            raise RuntimeError(f'spadl.{provider}.{name} resolves to {got!r}, not the port\'s {want!r}')
        if not any(issubclass(w.category, DeprecationWarning) for w in caught):
            raise RuntimeError(f'spadl.{provider}.{name} resolved with no DeprecationWarning')
        resolved[f'spadl.{provider}.{name}'] = f'{got.__module__}.{got.__qualname__}'
    loaded = sorted(m for m in ('pandas', 'lxml') if m in sys.modules)
    if loaded:
        raise RuntimeError(f'the providers\' modules loaded {loaded}')
    return {'modules': modules, 'resolved': resolved}


def canonical(obj: Any) -> Any:
    """A parser's records in one canonical JSON form: a mapping becomes its
    ``[key, value]`` pairs sorted by key, a tuple a list, a ``datetime`` its
    ISO string."""
    if isinstance(obj, dict):
        pairs = [[canonical(k), canonical(v)] for k, v in obj.items()]
        return sorted(pairs, key=lambda kv: json.dumps(kv[0]))
    if isinstance(obj, (list, tuple)):
        return [canonical(v) for v in obj]
    if isinstance(obj, datetime.datetime):
        return obj.isoformat()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f'no canonical form for {type(obj).__name__}: {obj!r}')


def parser_records(parsers: Any, name: str, path: str, ids: Dict[str, Any]) -> Dict[str, Any]:
    """Every pandas-free ``extract_*`` method's records of the parser
    ``name`` (a class of the module ``parsers``) over the file ``path``."""
    cls = getattr(parsers, name)
    parser = cls(path, **ids)
    skip = PANDAS_EXTRACTS.get(name, ())
    return {m: getattr(parser, m)() for m in sorted(dir(cls)) if m.startswith('extract_') and m not in skip}


def provider_digest(records: Dict[str, Any]) -> str:
    """sha256 of the records' canonical form (compact JSON)."""
    text = json.dumps(canonical(records), separators=(',', ':'), allow_nan=False)
    return hashlib.sha256(text.encode()).hexdigest()


def provider_digests(parsers: Any) -> Dict[str, Dict[str, Any]]:
    """Each parser of :data:`PROVIDER_PARSERS` (from the module ``parsers``)
    run over its fixture file: the digest of its records and their count
    by method."""
    out = {}
    for name, rel, ids in PROVIDER_PARSERS:
        records = parser_records(parsers, name, os.path.join(DATASETS, rel), ids)
        out[name] = {'digest': provider_digest(records), 'records': {m: len(r) for m, r in records.items()}}
    return out


def provider_games() -> Dict[str, Dict[str, Any]]:
    """:data:`PROVIDER_SPADL`'s layouts: ``home_team_id`` and the actions'
    columns as numpy arrays."""
    with open(PROVIDER_SPADL) as fh:
        record = json.load(fh)
    return {layout: {'home_team_id': r['home_team_id'],
                     'columns': {c: np.asarray(v) for c, v in r['actions'].items()}}
            for layout, r in record.items()}


def provider_phase(device: torch.device, card: str = 'CPU', hidden: Tuple[int, ...] = HIDDEN) -> Dict[str, Any]:
    """Phase 20, the Wyscout and Opta loaders on the card's machine.

    (a) :func:`provider_imports`. (b) Each parser of
    :data:`PROVIDER_PARSERS` over its fixture file, every pandas-free
    ``extract_*`` method, its records' digest held to
    :data:`PROVIDER_DIGESTS`. (c) The
    six layouts' games (loader, then ``convert_to_actions``, read from
    :data:`PROVIDER_SPADL`) packed into one batch as phase 19 packs its
    columns, rated by phase 4's model (two seeded ``hidden`` MLP heads)
    with B1's count zeroed just before and read just after (one launch on
    the card), held to ``rate_batch_reference`` and to the same model's
    values on the CPU within 1e-5; on the card, B1 against its plain
    version on the operands ``rate_batch`` hands it.
    """
    from socceraction_tpu_torch.data.opta import parsers

    label = 'providers'
    t_phase = time.perf_counter()
    imports = provider_imports()
    print(f"{label} (a): {len(imports['modules'])} modules imported, neither pandas nor lxml loaded; "
          f"{json.dumps(imports['resolved'])}")

    t0 = time.perf_counter()
    records = provider_digests(parsers)
    parse_s = time.perf_counter() - t0
    print(f'{label} (b): {len(records)} parsers over the fixture feeds in {parse_s:.3f} s on the host ({card}): '
          f'{json.dumps(records)}')
    wrong = {name: r['digest'] for name, r in records.items() if r['digest'] != PROVIDER_DIGESTS[name]}
    if wrong:
        raise RuntimeError(f'{label}: parser records hash to {wrong}, not {PROVIDER_DIGESTS}')

    games = provider_games()
    counts = {layout: len(g['columns']['game_id']) for layout, g in games.items()}
    if counts != PROVIDER_ACTIONS:
        raise RuntimeError(f'{label}: the file holds {counts} actions, not {PROVIDER_ACTIONS}')
    batch = pack_chain_games([g['columns'] for g in games.values()],
                             [g['home_team_id'] for g in games.values()], device)
    model = make_model(device, hidden)
    sync(device)
    gm.fused_first_layer_quant.launches = 0
    seg.segment_sum.launches = 0
    t0 = time.perf_counter()
    values = model.rate_batch(batch)
    sync(device)
    rate_s = time.perf_counter() - t0
    launches = gm.fused_first_layer_quant.launches
    segment_launches = seg.segment_sum.launches
    if launches != kernel_launches(1, device):
        raise RuntimeError(f'{label}: rate_batch launched B1 {launches} times, not {kernel_launches(1, device)}')
    if tuple(values.shape) != (batch.n_games, batch.max_actions, 3) or not bool(
            torch.isfinite(values[batch.mask]).all()):
        raise RuntimeError(f'{label}: rate_batch gave {tuple(values.shape)} values, or values not finite')
    ref_gap = masked_gap(values, model.rate_batch_reference(batch), batch.mask)
    with tempfile.TemporaryDirectory() as tmp:
        model.save_model(tmp)
        cpu_model = load_model(tmp, device='cpu')
    cpu_batch = batch.to('cpu')
    cpu_gap = masked_gap(values.cpu(), cpu_model.rate_batch(cpu_batch), cpu_batch.mask)
    print(f'{label} (c): layouts {json.dumps(counts)} packed as {batch.n_games} x {batch.max_actions}; '
          f'rate_batch (its first call at this shape) in {rate_s * 1e3:.3f} ms synced, B1 launches {launches}, B2 {segment_launches}; max |rate_batch - '
          f'rate_batch_reference| {ref_gap:.3e}, max |{device.type} - CPU| {cpu_gap:.3e} (limits 1e-5; {card})')
    if not (ref_gap <= 1e-5 and cpu_gap <= 1e-5):
        raise RuntimeError(f'{label}: rate_batch is {ref_gap} from its reference and {cpu_gap} from the CPU')
    b1 = None
    if device.type == 'cuda':
        b1 = check_first_layer(device, torch.float32, ops=first_layer_operands_of(model, batch))
        print(f"kernel gather_matmul on {label}' operands vs plain ({card}): {json.dumps(b1)}")
    wall = time.perf_counter() - t_phase
    print(f'{label}: phase 20 in {wall:.1f} s')
    return {'imports': imports, 'records': records, 'actions': counts, 'launches': launches,
            'segment_launches': segment_launches, 'ref_gap': ref_gap, 'cpu_gap': cpu_gap, 'b1': b1, 'wall_s': wall}


# -- phase 21: seq and mixed heads behind the rating service ----------------------------------

#: Where phase 21's registry lives (git-ignored, removed at the end).
SEQ_SERVE_DIR = os.path.join('build', 'serve_seq')
#: The seed of the window bands' request lengths.
SEQ_BAND_SEED = 21


class SeqServeSizes(NamedTuple):
    """Phase 21's shapes: phase 16's service shape (the JAX service's
    defaults), the window bands' closed-loop clients and requests, phase
    16's mixed traffic (``clients`` x ``mixed_requests``, ``low`` to
    ``max_actions`` actions), the cross-family swap's clients and the
    drill's requests."""

    max_actions: int = ACTIONS
    max_batch_size: int = 64
    max_wait_ms: float = 2.0
    max_queue: int = 256
    clients: int = 16
    band_requests: int = 4
    mixed_requests: int = 32
    low: int = 1200
    swap_clients: int = 4
    swap_requests: int = 8
    drill_requests: int = 4


def seq_pair(device: torch.device) -> VAEP:
    """Standard VAEP with two seq heads at the default widths (32, 64, 64),
    seeds 0 and 1."""
    return VAEP(models={'scores': make_seq_head(VAEP, device, seed=0),
                        'concedes': make_seq_head(VAEP, device, seed=1)}, device=device)


def mixed_pair(mlp: VAEP, device: torch.device) -> VAEP:
    """Phase 12's mixed pair: ``mlp``'s scores head and a seq concedes head."""
    return VAEP(models={'scores': mlp._models['scores'], 'concedes': make_seq_head(VAEP, device)},
                device=device)


def window_counts(rungs: Tuple[int, ...]) -> Dict[str, float]:
    """``seq/window_slices`` of every rung in the process registry."""
    snap = REGISTRY.snapshot()
    return {str(r): snap.value('seq/window_slices', window=str(r)) for r in rungs}


@contextlib.contextmanager
def b1_calls() -> Any:
    """Count the calls of B1's wrappers (``fused_first_layer`` and
    ``fused_first_layer_quant``, as ``ops/fused.py`` reaches them) in the
    enclosed block, on the CPU as on the card; yields the count's reader."""
    with captured(fused_ops, 'fused_first_layer') as plain, \
            captured(fused_ops, 'fused_first_layer_quant') as quant:
        yield lambda: len(plain) + len(quant)


def request_gaps(model: VAEP, reqs: List[ServeRequest], results: List[Any], device: torch.device,
                 label: str) -> Dict[str, Any]:
    """Each request's values against its own one-game
    ``rate_batch_reference`` (held to :data:`SERVE_ATOL`) and against a
    full-window ``rate_batch`` of the same game (reported, with whether
    every request is bitwise that)."""
    ref_gap = full_gap = 0.0
    bitwise = True
    for req, got in zip(reqs, results):
        ref, full = request_references(model, req, device)
        if got.shape != (req.n, 3) or not np.isfinite(got).all():
            raise RuntimeError(f'{label}: a request came back {got.shape}, finite {np.isfinite(got).all()}')
        ref_gap = max(ref_gap, float(np.abs(got - ref).max()))
        full_gap = max(full_gap, float(np.abs(got - full).max()))
        bitwise = bitwise and bool(np.array_equal(got, full))
    if ref_gap > SERVE_ATOL:
        raise RuntimeError(f'{label}: a request is {ref_gap} from rate_batch_reference (limit {SERVE_ATOL})')
    return {'max_abs_err_vs_reference': ref_gap, 'max_abs_err_vs_full_window_rate_batch': full_gap,
            'bitwise_full_window_rate_batch': bitwise}


def flush_beside_bare(svc: RatingService, model: VAEP, reqs: List[ServeRequest], bucket: int,
                      device: torch.device) -> Dict[str, Any]:
    """A ``bucket``-request flush of ``reqs`` (synced median) beside a bare
    ``rate_batch`` of the same padded batch, cut to the flush's window rung
    as the service cuts it."""
    payloads = [serve_service._Payload(r.staging, r.gs, keep=(0, r.n)) for r in reqs[:bucket]]
    host, gs = serve_service._pad_to_bucket(
        serve_service._concat_games([r.staging for r in reqs[:bucket]]),
        np.concatenate([r.gs for r in reqs[:bucket]]), bucket)
    rung = bucket_window(max(r.n for r in reqs[:bucket]), host.max_actions) if model.time_rungs \
        else host.max_actions
    if rung < host.max_actions:
        host, gs = serve_service._slice_window(host, gs, rung)
    batch, overrides = serve_service._upload(host, gs, device)
    flush_s = synced_median(lambda: svc._flush(payloads, bucket), device)
    bare_s = synced_median(lambda: model.rate_batch(batch, dense_overrides=overrides, bucket=False), device)
    return {'bucket': bucket, 'window': rung, 'actions': int(host.total_actions), 'flush_s': flush_s,
            'bare_rate_batch_s': bare_s, 'flush_over_bare': flush_s / bare_s}


def profiled_flush_reads(svc: RatingService, reqs: List[ServeRequest], bucket: int,
                         device: torch.device, label: str) -> Dict[str, Any]:
    """One ``bucket``-request flush under the profiler: no host read before
    its values copy on a card (:func:`read_events`)."""
    from torch.profiler import ProfilerActivity, profile

    payloads = [serve_service._Payload(r.staging, r.gs, keep=(0, r.n)) for r in reqs[:bucket]]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    sync(device)
    with profile(activities=activities) as prof:
        svc._flush(payloads, bucket)
    reads = read_events(prof)
    # on the CPU every tensor is a host tensor: only a card's read waits
    if device.type == 'cuda' and reads['before_copy']:
        raise RuntimeError(f'{label}: the profiled flush read the device before its values copy: {reads}')
    return reads


def seq_serve_phase(
    mlp: VAEP, device: torch.device, card: str = 'CPU', sizes: SeqServeSizes = SeqServeSizes(),
) -> Dict[str, Any]:
    """Phase 21: seq and mixed heads behind ``RatingService`` at phase 16's
    shape. Returns B1's launches by part and B1 at a bucket-64 flush's
    operands of the swap's MLP version (on a card).

    The seq pair (:func:`seq_pair`) snaps each flush's action axis to its
    window rung; the mixed pair (:func:`mixed_pair`) rates on the
    materialized path, which reaches no B1 wrapper: its MLP head reads the
    feature tensor, as in the JAX package. Requests enter at ``_submit``
    (:func:`submit_request`), built from seeded arrays. (a) ``warmup()``:
    every (bucket, window rung) shape of the seq pair, every bucket of the
    mixed pair; (b) each window band in turn (lengths in (previous rung,
    rung], seed 21) from closed-loop clients, every flush of the band at
    its rung (``seq/window_slices``), then phase 16's mixed traffic; each
    request held to its one-game reference and set beside a full-window
    ``rate_batch``; a bucket-64 flush at the smallest and the full window
    beside a bare ``rate_batch``, profiled flushes, the card's idle share
    under the full-window band; (c) a registry with the MLP model as v1
    and the seq pair as v2: a swap to v2 while clients submit, every v2
    shape warmed before v2 is activated, then a rollback; (d) B1's library
    made to fail under mixed-pair flushes.
    """
    label = f'seq serve ({device}, {card})'
    A = sizes.max_actions
    shape = dict(max_actions=A, max_batch_size=sizes.max_batch_size,
                 max_wait_ms=sizes.max_wait_ms, max_queue=sizes.max_queue)
    rungs = window_ladder(A)
    launches: Dict[str, int] = {}
    t_phase = time.perf_counter()

    def b1() -> int:
        return gm.fused_first_layer_quant.launches

    seq_model = seq_pair(device)
    mixed = mixed_pair(mlp, device)
    paths = {'seq': seq_model._rating_path(), 'mixed': mixed._rating_path()}
    if paths != {'seq': 'seq', 'mixed': 'materialized'} or not seq_model.time_rungs or mixed.time_rungs:
        raise RuntimeError(f'{label}: rating paths {paths}, time rungs {seq_model.time_rungs}, '
                           f'{mixed.time_rungs}')

    # -- (a) warm-up: every (bucket, window rung) shape of the seq pair, every
    # bucket of the mixed pair
    services: Dict[str, RatingService] = {}
    warm: Dict[str, Any] = {}
    for name, model in (('seq', seq_model), ('mixed', mixed)):
        svc = RatingService(model, **shape)
        wins = window_counts(rungs)
        gm.fused_first_layer_quant.launches = 0
        with b1_calls() as calls:
            sync(device)
            t0 = time.perf_counter()
            svc.warmup()
            sync(device)
            wall = time.perf_counter() - t0
        want = len(svc.ladder) * (len(rungs) if name == 'seq' else 1)
        sliced = delta(window_counts(rungs), wins)
        want_sliced = {str(r): float(len(svc.ladder) if name == 'seq' and r < A else 0) for r in rungs}
        if svc.compiled_shapes != want or b1() or calls() or sliced != want_sliced:
            raise RuntimeError(f'{label}: {name} warm-up: {svc.compiled_shapes} shapes (want {want}), '
                               f'B1 {b1()} launches and {calls()} wrapper calls, window slices {sliced}')
        services[name] = svc
        warm[name] = {'compiled_shapes': svc.compiled_shapes, 'wall_s': wall, 'window_slices': sliced,
                      'b1': b1()}
    launches['warmup'] = sum(w['b1'] for w in warm.values())
    print(f'{label}: (a) warmup {json.dumps({"ladder": list(services["seq"].ladder), "window_rungs": list(rungs), **warm})}')

    # -- (b) traffic by window band, then the mixed pair's traffic
    svc = services['seq']
    takes = count_takes(svc)
    rng = np.random.default_rng(SEQ_BAND_SEED)
    n_band = sizes.clients * sizes.band_requests
    top = svc.ladder[-1]
    bands: Dict[str, Any] = {}
    band_reqs: Dict[int, List[ServeRequest]] = {}
    busy = None
    prev = 0
    launches['seq bands'] = 0
    for r in rungs:
        reqs = [serve_request(rng, int(n), A) for n in rng.integers(prev + 1, r + 1, size=n_band)]
        band_reqs[r] = reqs
        prev = r
        before, wins, first = serve_counts(), window_counts(rungs), len(takes)
        out: Dict[str, Any] = {}

        def run(reqs: List[ServeRequest] = reqs) -> None:
            out['results'], out['walls'], out['wall'] = timed_clients(svc, reqs, sizes.clients)

        gm.fused_first_layer_quant.launches = 0
        with b1_calls() as calls:
            if r == A and device.type == 'cuda':
                busy = device_busy(run)
            else:
                run()
        n_calls = calls()
        counts = delta(serve_counts(), before)
        sliced = delta(window_counts(rungs), wins)
        flushes = takes[first:]
        want_sliced = {str(q): float(len(flushes) if q == r and r < A else 0) for q in rungs}
        if sliced != want_sliced or counts['fallback_flushes'] or b1() or n_calls or \
                svc.compiled_shapes != warm['seq']['compiled_shapes']:
            raise RuntimeError(f'{label}: band {r}: {len(flushes)} flushes, window slices {sliced}, '
                               f"fallback {counts['fallback_flushes']}, B1 {b1()} launches and {n_calls} "
                               f'wrapper calls, shapes {svc.compiled_shapes}')
        launches['seq bands'] += b1()
        buckets: Dict[str, int] = {}
        for _n, b in flushes:
            buckets[str(b)] = buckets.get(str(b), 0) + 1
        bands[str(r)] = {**traffic_record(reqs, out['walls'], out['wall']),
                         'lengths': [min(q.n for q in reqs), max(q.n for q in reqs)],
                         'flushes': len(flushes), 'window_slices': sliced[str(r)], 'buckets': buckets,
                         'fallback_flushes': counts['fallback_flushes'], 'b1_launches': b1(),
                         'b1_wrapper_calls': n_calls,
                         **request_gaps(seq_model, reqs, out['results'], device, f'{label}: band {r}')}
        print(f'{label}: (b) window band {r} ({card}): {json.dumps(bands[str(r)])}')
    cost = {str(r): flush_beside_bare(svc, seq_model, band_reqs[r], top, device) for r in (rungs[0], A)}
    seq_reads = profiled_flush_reads(svc, band_reqs[A], top, device, f'{label}: seq')
    print(f'{label}: (b) a {top}-request flush beside a bare rate_batch of the same padded batch '
          f'(synced medians, {card}): {json.dumps(cost)}; profiled full-window flush {json.dumps(seq_reads)}; '
          f'the card under the {A} band: {json.dumps(busy)}')

    msvc = services['mixed']
    mtakes = count_takes(msvc)
    rng16 = np.random.default_rng(16)
    mreqs = [serve_request(rng16, int(rng16.integers(sizes.low, A + 1)), A)
             for _ in range(sizes.clients * sizes.mixed_requests)]
    before = serve_counts()
    gm.fused_first_layer_quant.launches = 0
    with b1_calls() as calls:
        mresults, mwalls, mwall = timed_clients(msvc, mreqs, sizes.clients)
    n_calls = calls()
    launches['mixed traffic'] = b1()
    counts = delta(serve_counts(), before)
    if counts['fallback_flushes'] or b1() or n_calls or msvc.compiled_shapes != warm['mixed']['compiled_shapes']:
        raise RuntimeError(f'{label}: mixed traffic: {len(mtakes)} flushes, fallback '
                           f"{counts['fallback_flushes']}, B1 {b1()} launches and {n_calls} wrapper calls, "
                           f'shapes {msvc.compiled_shapes}')
    mixed_rec = {**traffic_record(mreqs, mwalls, mwall), 'flushes': len(mtakes),
                 'mean_requests_per_flush': len(mreqs) / len(mtakes),
                 'fallback_flushes': counts['fallback_flushes'], 'b1_launches': b1(), 'b1_wrapper_calls': n_calls,
                 **request_gaps(mixed, mreqs, mresults, device, f'{label}: mixed')}
    mixed_rec['flush'] = flush_beside_bare(msvc, mixed, mreqs, top, device)
    mixed_rec['profiled_flush'] = profiled_flush_reads(msvc, mreqs, top, device, f'{label}: mixed')
    print(f'{label}: (b) mixed pair traffic ({card}): {json.dumps(mixed_rec)}')

    # -- (c) a hot swap across families: the MLP model as v1, the seq pair as v2
    shutil.rmtree(SEQ_SERVE_DIR, ignore_errors=True)
    os.makedirs(SEQ_SERVE_DIR)
    registry = ModelRegistry(os.path.join(SEQ_SERVE_DIR, 'registry'), device=device)
    registry.publish('vaep', '1', mlp)
    registry.publish('vaep', '2', seq_model)
    registry.activate('vaep', '1')
    versions = {v: registry.load('vaep', v) for v in ('1', '2')}
    ssvc = RatingService(registry=registry, **shape)
    ssvc.warmup()
    v1_shapes = ssvc.compiled_shapes
    at_activation: Dict[str, Any] = {}
    real_activate = registry.activate

    def activate(name: str, version: Optional[str] = None) -> Any:
        # what the service had dispatched when v2 goes live
        if version == '2':
            at_activation.update(shapes=ssvc.compiled_shapes, window_slices=window_counts(rungs))
        return real_activate(name, version)

    registry.activate = activate  # type: ignore[method-assign]
    served: List[str] = []
    real_active = ssvc._active

    def active() -> Tuple[str, str, Any]:
        # the version each flush reads (once a flush, on the flusher thread)
        out = real_active()
        if threading.current_thread().name.startswith('serve-flusher'):
            served.append(out[1])
        return out

    ssvc._active = active  # type: ignore[method-assign]
    n_swap = sizes.swap_clients * sizes.swap_requests
    srng = np.random.default_rng(SEQ_BAND_SEED + 1)
    sreqs = [serve_request(srng, int(srng.integers(100, A + 1)), A) for _ in range(n_swap)]
    sresults: List[Any] = [None] * n_swap
    submitted = [0.0] * n_swap
    started, swapped = threading.Event(), threading.Event()
    done_lock = threading.Lock()
    done = [0]
    errors: List[BaseException] = []
    quarter = max(1, sizes.swap_requests // 4)

    def swap_client(c: int) -> None:
        try:
            for k in range(sizes.swap_requests):
                if k == sizes.swap_requests - quarter:
                    swapped.wait(timeout=300)  # the last requests go in after the swap
                i = c * sizes.swap_requests + k
                submitted[i] = time.monotonic()
                sresults[i] = submit_request(ssvc, sreqs[i]).result(timeout=300)
                with done_lock:
                    done[0] += 1
                    if done[0] >= sizes.swap_clients * quarter:
                        started.set()
        except BaseException as e:  # reported below
            errors.append(e)
            started.set()

    before, wins = serve_counts(), window_counts(rungs)
    gm.fused_first_layer_quant.launches = 0
    threads = [threading.Thread(target=swap_client, args=(c,)) for c in range(sizes.swap_clients)]
    for t in threads:
        t.start()
    started.wait(timeout=300)
    t0 = time.perf_counter()
    try:
        ssvc.swap_model('vaep', '2')
    finally:
        swapped.set()
    swap_s = time.perf_counter() - t0
    swap_done = time.monotonic()
    swapped_shapes = ssvc.compiled_shapes
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f'{label}: a swap client failed: {errors[0]!r}')
    t0 = time.perf_counter()
    ssvc.rollback_model()
    rollback_s = time.perf_counter() - t0
    back = [submit_request(ssvc, r).result(timeout=300) for r in sreqs[: sizes.swap_clients]]
    # read before the references below, which launch B1 for v1 too
    launches['swap'] = b1()
    counts = delta(serve_counts(), before)
    by_version = {'1': 0, '2': 0}
    after_swap = 0
    for req, got, t_sub in zip(sreqs, sresults, submitted):
        gaps = {v: float(np.abs(got - request_references(m, req, device)[0]).max())
                for v, m in versions.items()}
        match = [v for v, g in gaps.items() if g <= SERVE_ATOL]
        other = [v for v, g in gaps.items() if g > SERVE_APART]
        if len(match) != 1 or len(other) != 1:
            raise RuntimeError(f'{label}: a request is not wholly one version: {gaps}')
        by_version[match[0]] += 1
        if t_sub > swap_done:
            after_swap += 1
            if match[0] != '2':
                raise RuntimeError(f'{label}: a request submitted after the swap was rated by v1')
    for req, got in zip(sreqs, back):
        if float(np.abs(got - request_references(versions['1'], req, device)[0]).max()) > SERVE_ATOL:
            raise RuntimeError(f'{label}: after rollback a request was not rated by v1')
    all_shapes = len(ssvc.ladder) * len(rungs)
    # v2 goes live with every one of its shapes dispatched: the shapes of
    # v1's ladder at the full window and v2's cut windows
    v1_flushes = served.count('1')
    want_b1 = kernel_launches(len(ssvc.ladder) + v1_flushes, device)  # the rollback's warm-up and v1's flushes
    if at_activation.get('shapes') != all_shapes or swapped_shapes != all_shapes or \
            ssvc.compiled_shapes != all_shapes or registry.active()[:2] != ('vaep', '1') or \
            after_swap == 0 or by_version['2'] == 0 or counts['fallback_flushes'] or launches['swap'] != want_b1:
        raise RuntimeError(f'{label}: swap: shapes at v2 activation {at_activation}, after the swap '
                           f'{swapped_shapes}, at the end {ssvc.compiled_shapes} (want {all_shapes}); '
                           f'active {registry.active()[:2]}; {after_swap} after the swap, by version '
                           f"{by_version}; fallback {counts['fallback_flushes']}; B1 {launches['swap']} (want {want_b1})")
    swap = {'requests': n_swap, 'by_version': by_version, 'submitted_after_swap': after_swap,
            'failed': 0, 'v1_compiled_shapes': v1_shapes, 'shapes_at_v2_activation': at_activation['shapes'],
            'window_slices_at_v2_activation': delta(at_activation['window_slices'], wins),
            'compiled_shapes': ssvc.compiled_shapes, 'swap_wall_s': swap_s, 'rollback_wall_s': rollback_s,
            'model_swaps': counts['swaps'], 'model_swaps_rollback': counts['rollbacks'],
            'flushes_by_version': {v: served.count(v) for v in ('1', '2')}, 'b1_launches': launches['swap']}
    print(f'{label}: (c) swap MLP v1 -> seq v2 and rollback ({card}): {json.dumps(swap)}')
    ssvc.close()
    # B1 at the operands a full bucket of v1's flush hands it
    b1_rec = None
    if device.type == 'cuda':
        host, gs = serve_service._pad_to_bucket(
            serve_service._concat_games([r.staging for r in mreqs[:top]]),
            np.concatenate([r.gs for r in mreqs[:top]]), top)
        batch, overrides = serve_service._upload(host, gs, device)
        b1_rec = fold_first_layer(mlp, batch, overrides)
        del batch, overrides
        print(f"{label}: kernel gather_matmul at a {top}-request flush's operands vs plain ({card}): "
              f'{json.dumps(b1_rec)}')
    shutil.rmtree(SEQ_SERVE_DIR, ignore_errors=True)

    # -- (d) B1 cannot load under mixed-pair flushes
    breaker_before = msvc.breaker.to_dict()
    before = serve_counts()
    attempts = [0]

    def no_b1(*args: Any, **kwargs: Any) -> Any:
        attempts[0] += 1
        if device.type == 'cuda':
            raise OSError('libgather_matmul.so: cannot open shared object file (kernel-fault drill)')
        raise cuda_build.KernelError('gather_matmul cannot be loaded (kernel-fault drill)')

    # as phase 16 (e): on the card the library load fails, on the CPU the wrapper
    patched = (cuda_build, 'load_library') if device.type == 'cuda' else (fused_ops, 'fused_first_layer_quant')
    real = getattr(*patched)
    setattr(*patched, no_b1)
    gm.fused_first_layer_quant.launches = 0
    outcomes: List[Any] = []
    try:
        for req in mreqs[: sizes.drill_requests]:
            try:
                outcomes.append(submit_request(msvc, req).result(timeout=300))
            except cuda_build.KernelError as e:
                outcomes.append(e)
    finally:
        setattr(*patched, real)
    counts = delta(serve_counts(), before)
    raised = [str(o) for o in outcomes if isinstance(o, BaseException)]
    bitwise = all(isinstance(o, np.ndarray) and np.array_equal(o, m) for o, m in zip(outcomes, mresults))
    unmoved = msvc.breaker.to_dict() == breaker_before
    if raised or attempts[0] or b1() or not unmoved or counts['fallback_flushes']:
        raise RuntimeError(f'{label}: B1 cannot load under mixed-pair flushes: raised {raised}, '
                           f'{attempts[0]} load attempts, B1 {b1()}, breaker {msvc.breaker.to_dict()} '
                           f'(was {breaker_before}), fallback {counts["fallback_flushes"]}')
    gaps = request_gaps(mixed, mreqs[: sizes.drill_requests], outcomes, device, f'{label}: drill')
    launches['drill'] = b1()
    print(f'{label}: (d) B1 cannot load under mixed-pair flushes ({card}): '
          f'{json.dumps({"requests": len(outcomes), "raised": len(raised), "b1_load_attempts": attempts[0], "breaker_unmoved": unmoved, "fallback_flushes": counts["fallback_flushes"], "health": msvc.health()["status"], "bitwise_the_undisturbed_values": bitwise, **gaps})}')
    for s in services.values():
        s.close()
    print(f'{label}: B1 launches {json.dumps(launches)}; phase 21 in {time.perf_counter() - t_phase:.1f} s')
    return {'launches': launches, 'b1': b1_rec, 'bands': bands, 'mixed': mixed_rec, 'swap': swap}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == '--scale-rank':
        # one of phase 14 (b)'s ranks, spawned by scale_two_ranks
        out_dir, device_type, sizes = sys.argv[2:5]
        scale_rank(out_dir, device_type, ScaleSizes(**json.loads(sizes)))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == '--fleet-replica':
        # one of phase 15's replica processes, spawned by fleet_phase
        fleet_dir, index, device_type = sys.argv[2:5]
        fleet_replica(fleet_dir, int(index), device_type)
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == '--aot-replica':
        # one of phase 17 (b)'s warm-tier children, spawned by lanes_phase
        root, version, device_type = sys.argv[2:5]
        aot_replica(root, version, device_type)
        return 0
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    # the cold-start timeline, anchored at the process's start: the
    # interpreter, torch and the package are the import phase
    with TIMELINE.phase('import', start_unix=TIMELINE.begin()):
        pass
    t_start = time.perf_counter()
    walls: Dict[str, float] = {}
    last = [t_start]

    def lap(name: str) -> None:
        """Close the wall of the phase ``name`` (seconds since the last lap)."""
        now = time.perf_counter()
        walls[name] = now - last[0]
        last[0] = now

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
    lap('build and kernel checks')

    # -- phase 4, the VAEP serving path: the entry points' default device
    # (the card), as a user calls them
    with TIMELINE.phase('device_upload'):
        model = make_model()
        batch = synthetic_batch(GAMES, ACTIONS, seed=0)
    with TIMELINE.phase('first_dispatch'):
        model.rate_batch(batch).cpu()
    TIMELINE.mark('first_rated_action')
    serving = serving_phase(model, batch, card, 'main path')
    # the values phase 15's replica 0 must reproduce bitwise
    phase4_values = model.rate_batch(batch).cpu()
    del batch
    torch.cuda.empty_cache()
    lap('phase 4 serving')

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
    # the fits' telemetry (card fits only so far): xt/* and the live roofline
    for line in metric_lines(('xt/',)):
        print(f'xT path telemetry ({card}): {json.dumps(line)}')
    for fn, entry in perf_snapshot().items():
        if fn.startswith('solve_xt'):
            print(f'xT path roofline ({card}): {json.dumps(entry)}')
    prof = device_breakdown(lambda: ExpectedThreat(l=192, w=125).fit(xt_batch))
    print(
        f"profile: one ExpectedThreat(192x125).fit, {prof['wall_ms']:.3f} ms wall under "
        f"the profiler, {prof['kernel_ms']:.3f} ms of kernels ({card})"
    )
    for row in prof['top']:
        print(f'  profile: {json.dumps(row)}')

    t0 = time.perf_counter()
    # the host copy of the draw is phase 9's season too
    xt_cpu = xt_batch.to('cpu')
    cpu_fits = xt_fits(xt_cpu, 'cpu')
    print(f'xT path (CPU, plain versions): four fits in {time.perf_counter() - t0:.1f} s')
    for name, fit in cpu_fits.items():
        print(f'xT path ({n_xt} actions, CPU): {name}: {json.dumps(xt_summary(fit))}')
    for name, err in compare_fits(card_fits, cpu_fits).items():
        print(f'xT path: card vs CPU: {name}: {json.dumps(err)}')

    fit16 = card_fits['ExpectedThreat 16x12']
    del xt_batch, card_fits, warm, cpu_fits
    torch.cuda.empty_cache()
    lap('xT path')

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
    lap('phase 6 training')

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
    lap('phase 7 atomic')

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
    torch.cuda.empty_cache()
    lap('phase 8 seq')

    # -- phase 9, the season feed: the xT draw from its packed cache -----------------
    feed = feed_phase(model, xt_cpu, fit16, device, card)
    del xt_cpu
    torch.cuda.empty_cache()
    lap('phase 9 feed')

    # -- phase 10, counterfactuals ------------------------------------------------------
    scenario = scenario_phase(model, device, card)
    torch.cuda.empty_cache()
    lap('phase 10 scenarios')

    # -- phase 11, telemetry on the card ------------------------------------------------
    t0 = time.perf_counter()
    telemetry = telemetry_phase(model, device, card)
    print(f'telemetry: phase 11 in {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    lap('phase 11 telemetry')

    # -- phase 12, the rating dispatch and the gate's statistics -----------------------
    t0 = time.perf_counter()
    rating = rating_phase(device, card)
    print(f'rating paths: phase 12 in {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    lap('phase 12 rating paths')

    # -- phase 13, the continuous-learning loop -----------------------------------------
    learn = learn_phase(device, card)
    torch.cuda.empty_cache()
    lap('phase 13 learning loop')

    # -- phase 14, the scale-out layer ------------------------------------------------
    scale_launches = scale_phase(device, card)
    torch.cuda.empty_cache()
    lap('phase 14 scale-out')

    # -- phase 15, the cross-process telemetry plane ----------------------------------
    fleet_launches = fleet_phase(model, phase4_values, device, card,
                                 phase4_median_s=serving['median_s'])
    torch.cuda.empty_cache()
    lap('phase 15 fleet')

    # -- phase 16, in-process serving -----------------------------------------------
    serve_launches, serve_fold, one_lane = serve_phase(model, device, card,
                                                       phase4_median_s=serving['median_s'])
    torch.cuda.empty_cache()
    lap('phase 16 serving')

    # -- phase 17, serving's outer tier: lanes, the warm tier, the frontend --------
    lane_launches = lanes_phase(model, device, card, one_lane=one_lane)
    torch.cuda.empty_cache()
    lap('phase 17 lanes, warm tier, frontend')

    # -- phase 18, the device work under the DataFrame layer -------------------------
    frame = frame_phase(device, fit16, card, fit_packed_wall_s=run['wall_s'])
    torch.cuda.empty_cache()
    lap('phase 18 frame layer')

    # -- phase 19, the synthetic quality tier ------------------------------------------
    quality = quality_phase(device, card)
    torch.cuda.empty_cache()
    lap('phase 19 quality tier')

    # -- phase 20, the providers' loaders ------------------------------------------------
    providers = provider_phase(device, card)
    torch.cuda.empty_cache()
    lap('phase 20 providers')

    # -- phase 21, seq and mixed heads behind the rating service ----------------------
    seq_serve = seq_serve_phase(model, device, card)
    del model
    torch.cuda.empty_cache()
    lap('phase 21 seq serving')

    for rec in seg_checks:
        print(f'kernel segment_sum vs plain ({card}): {json.dumps(rec)}')

    b1_paths = {
        'rate_batch': serving['launches']['gather_matmul'],
        'fit_packed': run['launches']['gather_matmul'],
        'atomic rate_batch': atomic_serving['launches']['gather_matmul'],
        'atomic fit_packed': atomic_run['launches']['gather_matmul'],
        'seq fit_packed': seq_run['launches']['gather_matmul'],
        'fed epoch rate_batch': feed['launches'],
        'atomic take rate_batch': feed['atomic_launches'],
        'rate_scenarios_batch': scenario['fold_launches'],
        'rate_scenarios_looped': scenario['loop_launches'],
        'telemetry phase': telemetry['launches']['gather_matmul'],
        'phase 12 (path matrix, predict_proba_device_batch)': rating['launches']['gather_matmul'],
        'learning loop (phase 13, 3 iterations)': learn['launches']['gather_matmul'],
        **scale_paths(scale_launches, 'gather_matmul'),
        **{f'phase15 {rid}': n for rid, n in fleet_launches.items()},
        **{f'phase16 {part}': n for part, n in serve_launches.items()},
        **{f'phase17 {part}': n for part, n in lane_launches.items()},
        "phase18 fit_rows(learner='mlp'), dense": frame['fit_launches']['gather_matmul'],
        'phase18 fitted model rate_batch': frame['rate_launches'],
        "phase19 fit_rows(learner='mlp'), dense (fit and control)": quality['fit_launches']['gather_matmul'],
        'phase19 held-out predict_proba_device_batch (2 models x 2 heads)': quality['launches'],
        "phase20 the providers' games rate_batch": providers['launches'],
        **{f'phase21 {part}': n for part, n in seq_serve['launches'].items()},
    }
    b2_paths = {
        'xT fits': seg_launches,
        'fit_packed': run['launches']['segment_sum'],
        'atomic fit_packed': atomic_run['launches']['segment_sum'],
        'seq fit_packed': seq_run['launches']['segment_sum'],
        'atomic seq fit_packed': aseq['launches']['segment_sum'],
        'fed xT fit': feed['fit_launches'],
        'telemetry phase': telemetry['launches']['segment_sum'],
        'phase 12 (shadow_replay, drift)': rating['launches']['segment_sum'],
        'learning loop (phase 13, 3 iterations)': learn['launches']['segment_sum'],
        **scale_paths(scale_launches, 'segment_sum'),
        "phase18 fit_rows(learner='mlp')": frame['fit_launches']['segment_sum'],
        "phase19 fit_rows(learner='mlp') (fit and control)": quality['fit_launches']['segment_sum'],
        "phase20 the providers' games rate_batch": providers['segment_launches'],
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
            atomic_train_b1['max_abs_err'], rating['kernels']['gather_matmul']['max_abs_err'],
            learn['kernel']['max_abs_err'], frame['b1']['max_abs_err'], quality['b1']['max_abs_err'],
            providers['b1']['max_abs_err'], seq_serve['b1']['max_abs_err'],
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
        'phase12_shape': rating['kernels']['gather_matmul'],
        # a scenario request's fold (P = 96 in bucket 128) through the service
        'scenario_fold_shape': serve_fold['b1_at_fold_shape'],
        'loop_training_shape': learn['kernel'],
        # the operands the frame-fitted model's rate_batch hands B1
        'phase18_operands': {k: frame['b1'][k] for k in (
            'shape', 'plan', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
        )},
        # the operands the quality tier's held-out scores hand B1
        'phase19_operands': {k: quality['b1'][k] for k in (
            'shape', 'plan', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
        )},
        # the operands the providers' games hand B1
        'phase20_operands': {k: providers['b1'][k] for k in (
            'shape', 'plan', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
        )},
        # the operands a full bucket of phase 21's MLP version hands B1
        'phase21_operands': {k: seq_serve['b1'][k] for k in (
            'shape', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
        )},
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
        'max_abs_err': max(rec['max_abs_err'] for rec in seg_checks + rating['kernels']['segment_sum']),
        # the 192 x 125 payoff shape, the one every matrix-free sweep runs
        'ms': sweep['ms'],
        'plain_ms': sweep['plain_ms'],
        'bound_ms': sweep['bound_ms'],
        'bound_by': sweep['bound_by'],
        'library_ms': sweep['library_ms'],
        'shapes': [
            {k: rec[k] for k in (
                'shape', 'segments', 'max_abs_err', 'plain_f32_max_abs_err', 'ms', 'event_ms',
                'plain_ms', 'library_ms', 'bound_ms', 'plan',
            )}
            for rec in seg_checks + rating['kernels']['segment_sum']
        ],
        'ptxas': cuda_build.ptxas_report('segment_sum'),
    }]
    lap('kernels line')
    print(f'chip_smoke: phase walls (s) {json.dumps(walls)}')
    print(f'chip_smoke: {time.perf_counter() - t_start:.1f} s in all')
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
