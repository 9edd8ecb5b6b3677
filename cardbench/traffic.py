"""The one generator of the benchmark's traffic, and the caller's base.

A traffic mix is a JSON file under ``cardbench/traffic/`` that this module
reads; it holds parameters only:

- ``kind``: the driver that calls the program, ``cardbench/drivers/<kind>.py``
  (found by name, :meth:`cardbench.spec.Spec.driver`): ``rate`` (each call
  rates the next ``games_per_call`` games of the season) or ``scenario``
  (each request values a perturbation grid over them);
- ``season_games``, ``actions``: the season kept on the device, and the
  padded length of a game;
- ``valid_low``, ``valid_high``: the range of a game's valid length;
- ``stratum_games``: the games over which lengths are stratified (below);
- ``games_per_call``;
- the kind's own parameters (``grid`` of ``scenario``: ``{"builder":
  "end_location", "nx": .., "ny": ..}``);
- ``samples``: how many answers of the window are held to the reference;
- ``trace_seconds``: how much of a traced run's window the profiler keeps.

Every seed does the same work: in each stratum the valid lengths are the
same equally spaced values in ``[valid_low, valid_high]``, in an order
drawn from the seed, and they come in mirrored pairs (``l`` beside
``valid_low + valid_high - l``), so every group of two pairs, and every
stratum, holds the same number of valid actions. The seed changes the
order and the content of the actions, not the amount of work.

A driver's ``Load`` subclasses :class:`ClosedLoop`, which holds what every
kind shares: the season cut into calls, the host buffers, the sample of
answers kept for the check, and the window. Its default window is one
caller in a closed loop (each call's values are copied to the host before
the next call starts); a kind with other arrivals or several callers
overrides :meth:`ClosedLoop.window`, timing each call through
:class:`Window`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import reference, trace as tracemod


def stratified_lengths(rng: np.random.Generator, traffic: Dict[str, Any]) -> np.ndarray:
    """The valid length of each game of the season (see the module doc)."""
    low, high = traffic['valid_low'], traffic['valid_high']
    stratum = traffic['stratum_games']
    if stratum % 4 or traffic['season_games'] % stratum:
        raise ValueError('a stratum holds a multiple of 4 games and divides the season')
    half = stratum // 2
    lower = low + np.rint((high - low) * (np.arange(half) + 0.5) / stratum).astype(np.int64)
    out = []
    for _ in range(traffic['season_games'] // stratum):
        pairs = np.stack([lower, low + high - lower], 1)[rng.permutation(half)]
        flip = rng.random(half) < 0.5
        pairs[flip] = pairs[flip][:, ::-1]
        out.append(pairs.reshape(-1))
    return np.concatenate(out)


class Season(NamedTuple):
    """The raw columns of every game (``(G, A)`` on the device, padding rows
    zeroed), each game's valid length on the host, and the valid mask."""

    fields: Dict[str, torch.Tensor]
    lengths: np.ndarray
    mask: torch.Tensor


def make_season(family: Any, traffic: Dict[str, Any], gen: torch.Generator,
                rng: np.random.Generator, device: torch.device) -> Season:
    """The season of a traffic mix, drawn from the seed on ``device``."""
    lengths = stratified_lengths(rng, traffic)
    n_games, n_actions = traffic['season_games'], traffic['actions']
    raw = family.draw(gen, n_games, n_actions, device)
    mask = (torch.arange(n_actions, device=device)[None, :]
            < torch.as_tensor(lengths, device=device)[:, None])
    fields = {n: torch.where(mask, t, torch.zeros((), dtype=t.dtype, device=device))
              for n, t in raw.items()}
    return Season(fields, lengths, mask)


class Item(NamedTuple):
    """One call's input: games ``[lo, hi)`` of the season, the program's
    batch of them, and the work it does (valid actions, times the
    perturbations of a scenario)."""

    lo: int
    hi: int
    batch: Any
    work: int


class Call:
    """One call of the window: host clock at entry, at the entry's return and
    once its values were on the host; its work; CUDA events at entry and
    after the copy, and the device milliseconds between them."""

    __slots__ = ('t_entry', 't_return', 't_end', 'work', 'ok', 'events', 'device_ms')

    def __init__(self) -> None:
        self.work, self.ok, self.events, self.t_return = 0, False, None, 0.0


class Window:
    """The record of a window: its calls, timed by :meth:`timed`, its failed
    calls and the profiler over its first ``trace_seconds`` (``None``: no
    profiler)."""

    def __init__(self, device: torch.device, trace_seconds: Optional[float]) -> None:
        self.cuda = device.type == 'cuda'
        self.device = device
        self.trace_seconds = trace_seconds
        self.prof = None
        if trace_seconds is not None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()
        self.calls: List[Call] = []
        self.traced: Optional[int] = None
        self.failed, self.errors = 0, []
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def timed(self, load: 'ClosedLoop', i: int) -> Call:
        """Make call ``i`` of ``load`` and record it; a call that raises
        counts as failed and the window goes on."""
        call = Call()
        if self.cuda:
            call.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            call.events[0].record()
        call.t_entry = time.perf_counter()
        tracing = self.prof is not None and self.traced is None
        scope = torch.profiler.record_function(tracemod.CALL_RANGE) if tracing else contextlib.nullcontext()
        try:
            with scope:
                item, call.t_return = load.call(i)
            call.work, call.ok = item.work, True
        except Exception as e:
            self.failed += 1
            self.errors.append(f'{type(e).__name__}: {e}')
        call.t_end = time.perf_counter()
        if self.cuda:
            call.events[1].record()
        self.calls.append(call)
        if tracing and call.t_end - self.t0 >= self.trace_seconds:
            self.prof.stop()
            self.traced = len(self.calls)
        return call

    def finish(self) -> Dict[str, Any]:
        """Stop the profiler, wait for the device, and return the window:
        ``calls``, ``wall_s`` (first entry's start to the last call's end),
        ``failed``, the first ``errors``, ``prof`` and ``traced`` (the
        calls the profiler saw)."""
        if self.prof is not None and self.traced is None:
            self.prof.stop()
            self.traced = len(self.calls)
        if self.cuda:
            torch.cuda.synchronize(self.device)
        for c in self.calls:
            c.device_ms = (c.events[0].elapsed_time(c.events[1]) if self.cuda
                           else 1e3 * (c.t_end - c.t_entry))
        return {'calls': self.calls, 'wall_s': self.calls[-1].t_end - self.t0,
                'failed': self.failed, 'errors': self.errors[:3], 'prof': self.prof,
                'traced': self.traced}


class ClosedLoop:
    """The caller of one traffic mix; a driver's ``Load`` subclasses it.

    Set-up makes every call's batch from views of the season, the host
    buffers the values are copied into, and the sample of answers to keep.
    A driver gives :meth:`values` (the program's values of one call) and,
    where its kind needs them, :meth:`setup`, :meth:`value_shape`,
    :meth:`reference_inputs`, ``perturbations``, ``work_unit`` and
    :meth:`window`.
    """

    #: What a call's work counts: ``actions`` rated, or ``values`` (actions
    #: times perturbations). The throughput metrics read only their own unit.
    work_unit = 'actions'
    #: Values a valid action gets in one call.
    perturbations = 1

    def __init__(self, traffic: Dict[str, Any], config: Dict[str, Any], adapter: Any,
                 program: Any, season: Season, family: Any, rng: np.random.Generator,
                 device: torch.device) -> None:
        self.traffic, self.adapter, self.program, self.season = traffic, adapter, program, season
        self.setup(family)
        per = traffic['games_per_call']
        if traffic['season_games'] % per:
            raise ValueError('games_per_call must divide the season')
        self.items = []
        for lo in range(0, traffic['season_games'], per):
            hi = lo + per
            fields = {n: t[lo:hi] for n, t in season.fields.items()}
            total = int(season.lengths[lo:hi].sum())
            batch = adapter.batch(config, fields, season.mask[lo:hi], total)
            self.items.append(Item(lo, hi, batch, self.perturbations * total))
        shape = self.value_shape(per, traffic['actions'])
        pin = device.type == 'cuda'
        n_keep = traffic['samples']
        # one buffer per kept answer, and one the next call is copied into
        self.buffers = [torch.empty(shape, pin_memory=pin) for _ in range(n_keep + 1)]
        self.spare = n_keep
        self.kept: List[Optional[Item]] = [None] * n_keep
        self.rng = rng

    def setup(self, family: Any) -> None:
        """A kind's own set-up, before the batches are made."""

    def value_shape(self, games: int, actions: int) -> Tuple[int, ...]:
        """The shape of one call's values."""
        return (games, actions, 3)

    def values(self, item: Item) -> torch.Tensor:
        """The program's values of one call, on its device."""
        raise NotImplementedError

    def reference_inputs(self, item: Item) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The raw fields and valid mask the reference rates for ``item``,
        in the layout of the call's values."""
        return ({n: t[item.lo:item.hi] for n, t in self.season.fields.items()},
                self.season.mask[item.lo:item.hi])

    def call(self, i: int, keep: bool = True) -> Any:
        """Make call ``i`` (items cycle) and copy its values to the host;
        returns the item and the host clock at the entry's return.

        The answers kept for the check are a uniform sample of the window's
        calls (reservoir sampling with the seed's generator): the call's
        values land in a spare buffer, which takes a kept slot when drawn.
        ``keep=False`` (warm-up) keeps nothing.
        """
        item = self.items[i % len(self.items)]
        n_keep = len(self.kept)
        slot = n_keep if not keep else i if i < n_keep else int(self.rng.integers(0, i + 1))
        out = self.buffers[self.spare]
        values = self.values(item)
        t_return = time.perf_counter()
        out.copy_(values)
        if slot < n_keep:
            self.buffers[self.spare], self.buffers[slot] = self.buffers[slot], out
            self.kept[slot] = item
        return item, t_return

    def window(self, seconds: float, device: torch.device,
               trace_seconds: Optional[float]) -> Dict[str, Any]:
        """One caller in a closed loop until ``seconds`` have passed; with
        ``trace_seconds`` the profiler records the window's first part."""
        w = Window(device, trace_seconds)
        while True:
            call = w.timed(self, len(w.calls))
            if call.t_end - w.t0 >= seconds:
                return w.finish()

    def answers(self) -> List[Any]:
        """``(item, host values)`` of each kept answer."""
        return [(item, self.buffers[j]) for j, item in enumerate(self.kept) if item is not None]

    def release(self) -> None:
        """Drop the program and its batches (the season stays: it is the
        reference's input)."""
        self.program = None
        self.items = [item._replace(batch=None) for item in self.items]
        self.kept = [None if k is None else k._replace(batch=None) for k in self.kept]


def judge(model: reference.Model, load: ClosedLoop, answers: List[Any],
          control: bool = False) -> Dict[str, Any]:
    """Hold each ``(item, host values)`` answer to the reference over its
    valid actions: the widest gap (:func:`reference.gaps`) and the count of
    values that are not finite. With ``control`` the values judged are the control's
    (:func:`reference.values` with ``control=True``), not the answer's."""
    gap, nonfinite, compared = 0.0, 0, 0
    for item, got in answers:
        fields, mask = load.reference_inputs(item)
        device = mask.device
        if control:
            got = reference.values(model, fields, control=True)
        got = got.to(device).reshape(*mask.shape, 3).double()
        nonfinite += int((~torch.isfinite(got[mask])).sum())
        diff = reference.gaps(model, fields, got)[mask]
        gap = max(gap, float(torch.nan_to_num(diff, nan=float('inf')).max()))
        compared += 3 * int(mask.sum())
    return {'max_abs_gap': gap, 'nonfinite': nonfinite, 'answers': len(answers),
            'values_compared': compared}
