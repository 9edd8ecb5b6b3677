"""Durable iteration journal: crash-safe continuous learning.

A copy of the JAX package's ``socceraction_tpu/resil/journal.py``: the
JSONL is line for line that package's, so a journal written by either
package replays in the other.

The continuous-learning loop makes decisions with consequences that
outlive the process: games are *consumed* (never retrained), candidates
are *staged*, versions are *published* and *activated*. Before this
module, all of that state lived in process memory — a crash between
"games committed" and "verdict recorded" silently lost the decision
trail, and a crash between "version promoted" and "service swapped"
left the registry ahead of the serving process forever (the drift
watch's restart gap was one symptom). The journal fixes the class
of bug, not the instances:

- :class:`IterationJournal` — an append-only JSONL file, each line one
  stage of one iteration, written with a **single** ``os.write`` and
  ``fsync``'d before the stage's effects are allowed to proceed. A torn
  final line (crash mid-write) is detected and skipped on replay — the
  append is the atomic unit.
- :meth:`IterationJournal.replay` — folds the journal back into a
  :class:`JournalState`: every consumed game id (the no-double-training
  invariant), and the newest iteration's furthest stage so a restart
  knows exactly what was left half-done.

Stage grammar (one iteration, in order)::

    consumed        games committed to training; candidate tag staged
    verdict         gate decision (promoted | rejected | error)
    intent_publish  version chosen, about to atomically promote
    published       candidate renamed into the version slot
    activated       registry/service switched to the version

Recovery rules (:class:`~socceraction_tpu_torch.learn.loop.ContinuousLearner`
applies them at startup, counting ``resil/recoveries{outcome}``):

- ``consumed`` without ``verdict`` — the crash hit shadow/gate: games
  stay consumed (retraining them would double-count), the staged
  candidate stays for post-mortems, the iteration is recorded
  ``abandoned``.
- ``verdict promoted`` without ``published`` — finish the publish: the
  ``intent_publish`` version (or the next free one) is promoted from
  the still-staged candidate; the atomic ``os.replace`` means the
  registry is never half-published, and an intent whose version dir
  already exists simply proceeds to activation.
- ``published`` without ``activated`` — activate/swap the version and
  journal it; the decision trail completes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

__all__ = ['IterationJournal', 'JournalState']

#: stages in iteration order (replay uses the index as "progress")
STAGES = ('consumed', 'verdict', 'intent_publish', 'published', 'activated')


@dataclass
class JournalState:
    """What a journal says happened (the fold of :meth:`replay`)."""

    #: every game id any 'consumed' entry committed (the invariant set)
    consumed_games: Set[Any] = field(default_factory=set)
    #: completed iterations (reached a terminal stage)
    iterations: int = 0
    #: the newest iteration's entries when it did NOT reach a terminal
    #: stage (terminal: verdict in (rejected, error, abandoned), or
    #: activated) — the restart's work order; None when nothing pends
    open_iteration: Optional[Dict[str, Any]] = None
    #: torn/corrupt lines skipped during replay
    skipped_lines: int = 0

    @property
    def pending_stage(self) -> Optional[str]:
        """The furthest stage the open iteration reached (None if closed)."""
        return (
            self.open_iteration.get('stage')
            if self.open_iteration is not None
            else None
        )


class IterationJournal:
    """Append-only fsync'd JSONL journal of learning-loop iterations.

    Parameters
    ----------
    path : str
        The journal file; parent directories are created on first
        append. One journal belongs to one learner identity — two
        processes appending concurrently is outside the contract (the
        singleton learner is the loop's existing deployment shape).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()

    # -- writing ------------------------------------------------------------

    def append(self, stage: str, **fields: Any) -> Dict[str, Any]:
        """Durably append one stage entry; returns the entry written.

        One ``os.write`` of the whole line, then ``fsync``, so a crash
        leaves either the complete line or a torn tail — never an
        interleaved or silently-buffered entry. The write is the
        commit point: callers append *before* relying on the stage
        having happened.
        """
        entry = {'ts': round(time.time(), 6), 'stage': stage, **fields}
        data = (json.dumps(entry, sort_keys=True, default=str) + '\n').encode(
            'utf-8'
        )
        with self._lock:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            fd = os.open(
                self.path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644
            )
            try:
                # heal a torn tail: a crash mid-write leaves the file
                # without its trailing newline, and appending straight
                # onto it would glue THIS entry to the corrupt line
                # (replay would then skip both). A leading newline
                # isolates the torn bytes on their own skippable line.
                size = os.fstat(fd).st_size
                if size and os.pread(fd, 1, size - 1) != b'\n':
                    data = b'\n' + data
                os.write(fd, data)
                os.fsync(fd)
            finally:
                os.close(fd)
        return entry

    # -- reading ------------------------------------------------------------

    def entries(self) -> List[Dict[str, Any]]:
        """Every parseable entry, oldest first (torn tail skipped)."""
        out, _ = self._read()
        return out

    def _read(self) -> tuple:
        entries: List[Dict[str, Any]] = []
        skipped = 0
        try:
            with open(self.path, encoding='utf-8', errors='replace') as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entry = json.loads(line)
                    except json.JSONDecodeError:
                        skipped += 1  # torn tail from a mid-write crash
                        continue
                    if isinstance(entry, dict) and 'stage' in entry:
                        entries.append(entry)
                    else:
                        skipped += 1
        except FileNotFoundError:
            pass
        return entries, skipped

    def tail(self, n: int = 10) -> List[Dict[str, Any]]:
        """The newest ``n`` entries (for ``obsctl resil --journal``)."""
        return self.entries()[-max(0, int(n)):]

    def replay(self) -> JournalState:
        """Fold the journal into the restart work order (see module docs)."""
        entries, skipped = self._read()
        state = JournalState(skipped_lines=skipped)
        current: Optional[Dict[str, Any]] = None  # open iteration fold
        for entry in entries:
            stage = entry.get('stage')
            if stage == 'consumed':
                state.consumed_games.update(entry.get('games') or ())
                # a new iteration opens; a previous one still open at
                # this point crashed before its verdict — the learner
                # already recorded its recovery (or this journal
                # predates it); the newest open iteration wins
                current = {
                    'stage': 'consumed',
                    'tag': entry.get('tag'),
                    'games': list(entry.get('games') or ()),
                    'model_name': entry.get('model_name'),
                }
            elif current is None:
                continue  # stray entry without an open iteration
            elif stage == 'verdict':
                current['verdict'] = entry.get('verdict')
                current['stage'] = 'verdict'
                if entry.get('verdict') in ('rejected', 'error', 'abandoned'):
                    state.iterations += 1
                    current = None
            elif stage in ('intent_publish', 'published', 'activated'):
                current['stage'] = stage
                if entry.get('version') is not None:
                    current['version'] = entry.get('version')
                if stage == 'activated':
                    state.iterations += 1
                    current = None
        state.open_iteration = current
        return state
