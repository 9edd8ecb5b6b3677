"""Traffic capture: a bounded ring of recently served requests.

A copy of the JAX package's ``socceraction_tpu/serve/capture.py``, with
pandas imported only where a frame is built, so the module imports on a
machine without pandas.

Shadow evaluation (:mod:`socceraction_tpu_torch.learn.shadow`) judges a
candidate model on *the traffic the service actually saw*, not on a
held-out split — the replay-based evaluation PAPERS.md's "What Happened
Next?" (2106.01786) argues for. :class:`TrafficCapture` is the source of
that traffic: a thread-safe, bounded, host-only ring the
serving layer feeds as it serves (the learning loop reads it; a test or
a caller may record frames directly):

- **one-shot requests** — every successful ``RatingService.rate``
  submission records a copy of the request frame (``deque`` with
  ``maxlen``: the ring holds the most recent requests and silently
  drops the oldest);
- **streaming sessions** — every committed
  ``MatchSession.add_actions`` tick
  appends its new rows to a per-match stream, so a live match replays
  as the full action sequence it actually produced (suffix windows
  alone would truncate the label lookahead). Streams are bounded too:
  past ``max_sessions`` matches, the least-recently-updated stream is
  evicted.

Capture is copy-on-record (callers may mutate their frames after
submission) and never touches the device — recording costs a DataFrame
copy and a lock, cheap enough to leave on in production. ``Overloaded``
submissions are *not* captured: shed load never happened, and replaying
it would skew calibration toward burst traffic.

Everything is reported under the ``serve`` telemetry area
(``serve/captured_requests``, ``serve/captured_actions``,
``serve/capture_evictions{kind}``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import TYPE_CHECKING, Any, Dict, List, Tuple

from ..obs import counter

if TYPE_CHECKING:  # pandas is imported inside frames() only
    import pandas as pd

__all__ = ['TrafficCapture']


class TrafficCapture:
    """Bounded host-side ring of recently served rating traffic.

    Parameters
    ----------
    max_frames : int
        One-shot request frames kept (newest win).
    max_sessions : int
        Per-match session streams kept (least-recently-updated evicted).
    max_session_actions : int
        Row bound per session stream; a match longer than this keeps its
        most recent rows (the stream stays a contiguous suffix, so the
        replayed sequence is still a valid action sequence).
    """

    def __init__(
        self,
        max_frames: int = 256,
        max_sessions: int = 64,
        max_session_actions: int = 4096,
    ) -> None:
        self._lock = threading.Lock()
        self._frames: 'deque[Tuple[pd.DataFrame, Any]]' = deque(
            maxlen=int(max_frames)
        )
        self.max_sessions = int(max_sessions)
        self.max_session_actions = int(max_session_actions)
        self._sessions: 'OrderedDict[Any, Dict[str, Any]]' = OrderedDict()

    # -- recording (called by the serving layer) ---------------------------

    def record_frame(
        self, actions: 'pd.DataFrame', home_team_id: Any, *, copy: bool = True
    ) -> None:
        """Record one successfully submitted one-shot request.

        ``copy=False`` hands ownership of ``actions`` to the ring (the
        caller must never mutate it afterwards) — the serving layer
        copies on the *caller* thread at submit time so the flusher
        thread's success callback never pays a DataFrame copy inside the
        flush loop.
        """
        if self._frames.maxlen == 0:
            return  # one-shot capture disabled: no phantom metrics either
        frame = actions.copy() if copy else actions
        with self._lock:
            if len(self._frames) == self._frames.maxlen:
                counter('serve/capture_evictions', unit='count').inc(
                    1, kind='frame'
                )
            self._frames.append((frame, home_team_id))
        counter('serve/captured_requests', unit='count').inc(1, kind='rate')
        counter('serve/captured_actions', unit='actions').inc(len(frame))

    def record_session(
        self, match_id: Any, new_actions: 'pd.DataFrame', home_team_id: Any
    ) -> None:
        """Append one committed session tick's new rows to its stream."""
        if self.max_sessions <= 0 or self.max_session_actions <= 0:
            return  # session capture disabled: no phantom metrics either
        part = new_actions.copy()
        with self._lock:
            stream = self._sessions.get(match_id)
            if stream is None:
                stream = {'home_team_id': home_team_id, 'parts': [], 'rows': 0}
                self._sessions[match_id] = stream
                while len(self._sessions) > self.max_sessions:
                    self._sessions.popitem(last=False)
                    counter('serve/capture_evictions', unit='count').inc(
                        1, kind='session'
                    )
            self._sessions.move_to_end(match_id)
            stream['parts'].append(part)
            stream['rows'] += len(part)
            # keep the most recent rows: drop whole leading parts first,
            # then trim the (new) head part if one part alone overflows
            while (
                stream['rows'] > self.max_session_actions
                and len(stream['parts']) > 1
            ):
                dropped = stream['parts'].pop(0)
                stream['rows'] -= len(dropped)
            if stream['rows'] > self.max_session_actions:
                only = stream['parts'][0]
                stream['parts'][0] = only.iloc[
                    len(only) - self.max_session_actions :
                ]
                stream['rows'] = self.max_session_actions
        counter('serve/captured_requests', unit='count').inc(1, kind='session')
        counter('serve/captured_actions', unit='actions').inc(len(part))

    # -- replay (consumed by the learn loop) -------------------------------

    def frames(self) -> List[Tuple['pd.DataFrame', Any]]:
        """Every captured traffic unit as ``(frame, home_team_id)`` pairs.

        One-shot requests come back as recorded; each session stream as
        one concatenated frame in arrival order. Every returned frame is
        a fresh copy — callers may pack/mutate it freely without
        corrupting the ring (later replays must see the traffic as
        recorded; the bitwise-replay contract depends on it).

        Only reference snapshots happen under the ring lock; the copies
        and concats run outside it, so a replay over a full ring never
        stalls the serving threads' ``record_*`` calls. The stored
        frames themselves are immutable by construction (``record_*``
        copies on the way in and nothing mutates them after), so
        copying them lock-free is safe.
        """
        with self._lock:
            raw = list(self._frames)
            streams = [
                (list(s['parts']), s['home_team_id'])
                for s in self._sessions.values()
                if s['parts']
            ]
        out = [(frame.copy(), home) for frame, home in raw]
        for parts, home in streams:
            if len(parts) == 1:
                whole = parts[0].copy()
            else:
                import pandas as pd

                whole = pd.concat(parts)
            out.append((whole, home))
        return out

    def clear(self) -> None:
        """Drop everything captured so far (post-promotion reset)."""
        with self._lock:
            self._frames.clear()
            self._sessions.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._frames) + len(self._sessions)

    @property
    def total_actions(self) -> int:
        """Rows currently captured across frames and session streams."""
        with self._lock:
            return sum(len(f) for f, _ in self._frames) + sum(
                s['rows'] for s in self._sessions.values()
            )
