"""Synthetic SPADL actions: random batches, learnable games and seasons.

Port of ``socceraction_tpu/core/synthetic.py``. The draws are numpy's, in
the same order, so one seed gives a batch, a game or a season bitwise
equal to the JAX package's.

- :func:`synthetic_batch` draws a random but schema-valid ``(G, A)`` batch
  straight onto the device.
- :func:`synthetic_actions_frame` simulates one game's possession chains
  (a learnable feature-to-label structure). Its per-action loop is
  :func:`_chain_columns`, which needs no pandas and returns the columns as
  numpy arrays; the frame wrapper builds the JAX package's frame from
  them. A machine without pandas packs the columns directly.
- :func:`write_synthetic_season` and :func:`append_synthetic_games` write
  seasons into a :class:`~socceraction_tpu_torch.pipeline.store.SeasonStore`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional

import numpy as np

from ..config import CORNER_PRIOR, PENALTY_PRIOR
from ..device import DeviceLike, resolve_device
from ..spadl import config as spadlconfig
from .batch import ActionBatch, _from_numpy

if TYPE_CHECKING:  # pandas is imported inside the frame and store writers
    import pandas as pd

__all__ = [
    'append_synthetic_games',
    'synthetic_actions_frame',
    'synthetic_batch',
    'write_synthetic_season',
]

#: The SPADL columns of one chain game, in the frame's order (the frame
#: also has ``original_event_id`` after ``game_id``).
CHAIN_COLUMNS = (
    'game_id', 'action_id', 'period_id', 'time_seconds', 'team_id', 'player_id', 'start_x',
    'start_y', 'end_x', 'end_y', 'type_id', 'result_id', 'bodypart_id',
)
#: The generator's hidden state per action, as ``include_latents`` adds it.
LATENT_COLUMNS = ('latent_momentum', 'latent_fast_break', 'latent_hot', 'latent_exposure')


def _draw_spadl_columns(
    rng: np.random.Generator, G: int, A: int, float_dtype: Any, int_dtype: Any
) -> Dict[str, np.ndarray]:
    """Draw the marginal SPADL column distributions for a ``(G, A)`` grid.

    Passes dominate, then dribbles, then a tail over the other types;
    period and clock are monotone; end points are noisy displacements of
    start points.
    """
    n_types = len(spadlconfig.actiontypes)
    probs = np.full(n_types, 0.02)
    probs[spadlconfig.PASS] = 0.45
    probs[spadlconfig.DRIBBLE] = 0.25
    probs[spadlconfig.SHOT] = 0.03
    probs /= probs.sum()

    L, W = spadlconfig.field_length, spadlconfig.field_width
    type_id = rng.choice(n_types, size=(G, A), p=probs).astype(int_dtype)
    result_id = rng.choice(
        len(spadlconfig.results), size=(G, A), p=[0.25, 0.68, 0.02, 0.02, 0.02, 0.01]
    ).astype(int_dtype)
    bodypart_id = rng.choice(
        len(spadlconfig.bodyparts), size=(G, A), p=[0.85, 0.08, 0.05, 0.02]
    ).astype(int_dtype)
    period_id = np.sort(rng.integers(1, 5, size=(G, A)), axis=1).astype(int_dtype)
    time_seconds = np.sort(
        rng.uniform(0, 3000, size=(G, A)).astype(float_dtype), axis=1
    )
    start_x = rng.uniform(0, L, size=(G, A)).astype(float_dtype)
    start_y = rng.uniform(0, W, size=(G, A)).astype(float_dtype)
    end_x = np.clip(start_x + rng.normal(0, 12, size=(G, A)), 0, L).astype(float_dtype)
    end_y = np.clip(start_y + rng.normal(0, 8, size=(G, A)), 0, W).astype(float_dtype)
    is_home = rng.integers(0, 2, size=(G, A)).astype(bool)
    return {
        'type_id': type_id,
        'result_id': result_id,
        'bodypart_id': bodypart_id,
        'period_id': period_id,
        'time_seconds': time_seconds,
        'start_x': start_x,
        'start_y': start_y,
        'end_x': end_x,
        'end_y': end_y,
        'is_home': is_home,
    }


def synthetic_batch(
    n_games: int = 64,
    n_actions: int = 1664,
    *,
    fill: float = 1.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> ActionBatch:
    """A random but schema-valid ``(G, A)`` batch on ``device`` (default ``cuda``).

    ``n_actions`` defaults to 1664 (13 x 128), a typical SPADL game length
    rounded to the lane multiple; ``fill`` is the valid fraction of each
    game's action axis (the rest is padding).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    G, A = n_games, n_actions
    n_valid = max(2, int(A * fill))

    cols = _draw_spadl_columns(rng, G, A, np.float32, np.int32)
    mask = np.zeros((G, A), dtype=bool)
    mask[:, :n_valid] = True
    row_index = np.full((G, A), -1, dtype=np.int32)
    row_index[mask] = np.arange(G * n_valid, dtype=np.int32)
    cols['mask'] = mask
    cols['n_actions'] = np.full(G, n_valid, dtype=np.int32)
    cols['game_id'] = np.arange(G, dtype=np.int32)
    cols['row_index'] = row_index
    return _from_numpy(cols, dev)


# --- possession-chain generator -------------------------------------------
# Role layout for the 11-player rosters: 1=GK, 2-5 DEF, 6-8 MID, 9-11 FWD.
# Roles pick who acts where (defenders in the own third, forwards up front)
# and carry persistent finishing skill, so player identity correlates with
# shot quality the way it does in real data.
_ROLE_OF = {1: 'gk', **{j: 'def' for j in (2, 3, 4, 5)},
            **{j: 'mid' for j in (6, 7, 8)}, **{j: 'fwd' for j in (9, 10, 11)}}
_FINISH_MULT = {'gk': 0.5, 'def': 0.8, 'mid': 1.0, 'fwd': 1.2}
_ZONE_ROLE_P = {
    0: {'gk': 0.05, 'def': 0.55, 'mid': 0.30, 'fwd': 0.10},
    1: {'gk': 0.01, 'def': 0.29, 'mid': 0.45, 'fwd': 0.25},
    2: {'gk': 0.01, 'def': 0.14, 'mid': 0.40, 'fwd': 0.45},
}
_ROLES = ['gk', 'def', 'mid', 'fwd']


def _team_strength(team_id: int) -> float:
    """Persistent per-team quality in [0.94, 1.06], a pure function of the
    team id — the same team is the same strength in every generated game."""
    return 1.0 + float(np.random.default_rng(int(team_id)).uniform(-0.06, 0.06))


def _player_finish(player_id: int, j: int) -> float:
    """Persistent finishing skill: role multiplier × a per-player jitter
    derived from the player id, stable across games and seeds."""
    jit = float(np.random.default_rng(int(player_id)).uniform(-0.08, 0.08))
    return _FINISH_MULT[_ROLE_OF[j]] * (1.0 + jit)


def _chain_columns(
    game_id: int,
    *,
    home_team_id: int,
    away_team_id: int,
    n_actions: int,
    seed: int,
    include_latents: bool = False,
) -> Dict[str, np.ndarray]:
    """The per-action loop of :func:`synthetic_actions_frame`, without pandas.

    Returns :data:`CHAIN_COLUMNS` as numpy arrays (int64 and float64, the
    frame's dtypes), and :data:`LATENT_COLUMNS` with ``include_latents``.
    The draws are the JAX package's, in its order.
    """
    rng = np.random.default_rng(seed)
    n = int(n_actions)
    L, W = spadlconfig.field_length, spadlconfig.field_width
    half = n // 2

    other = {home_team_id: away_team_id, away_team_id: home_team_id}
    strength = {t: _team_strength(t) for t in (home_team_id, away_team_id)}
    finish = {
        t: {j: _player_finish(t * 1000 + j, j) for j in range(1, 12)}
        for t in (home_team_id, away_team_id)
    }

    CORNER = spadlconfig.actiontypes.index('corner_crossed')
    CROSS = spadlconfig.actiontypes.index('cross')
    SHOT = spadlconfig.SHOT
    SHOT_PENALTY = spadlconfig.SHOT_PENALTY
    PASS = spadlconfig.PASS
    DRIBBLE = spadlconfig.DRIBBLE
    FOOT = spadlconfig.bodyparts.index('foot')
    HEAD = spadlconfig.bodyparts.index('head')

    n_types = len(spadlconfig.actiontypes)
    # no shot-like vocabulary in the tail draw: penalties/corners are
    # explicit mechanics below, and a tail-drawn shot would resolve as a
    # move (~89% success) — unpredictable fake goals that poison both
    # label heads
    tail_types = np.array([
        t for t in range(n_types)
        if not spadlconfig.shot_like_mask[t]
        and t not in (PASS, DRIBBLE, CORNER, CROSS)
    ])

    team_id = np.empty(n, dtype=np.int64)
    player_id = np.empty(n, dtype=np.int64)
    type_id = np.empty(n, dtype=np.int64)
    result_id = np.empty(n, dtype=np.int64)
    bodypart_id = np.empty(n, dtype=np.int64)
    period_id = np.where(np.arange(n) < half, 1, 2).astype(np.int64)
    time_seconds = np.empty(n, dtype=np.float64)
    start_x = np.empty(n)
    start_y = np.empty(n)
    end_x = np.empty(n)
    end_y = np.empty(n)
    momentum_lat = np.empty(n)
    fast_lat = np.empty(n, dtype=bool)
    hot_lat = np.empty(n, dtype=bool)
    exposure_lat = np.empty(n)

    # mutable match state
    team = home_team_id if rng.integers(2) else away_team_id
    x, y = L / 2.0, W / 2.0
    t = 0.0
    momentum = 0.0
    fast_break = False
    hot = False
    exposure: Dict[int, float] = {home_team_id: 0.0, away_team_id: 0.0}
    pin_count: Dict[int, int] = {home_team_id: 0, away_team_id: 0}
    score = {home_team_id: 0, away_team_id: 0}
    pending = None  # 'penalty' | 'corner' | 'corner_shot'
    after_cross = False

    def new_possession(new_team, *, kickoff=False, p_hot=0.22):
        nonlocal team, momentum, fast_break, hot, x, y, after_cross
        team = new_team
        momentum = 0.0
        hot = bool(rng.random() < p_hot)
        fast_break = hot and bool(rng.random() < 0.5)
        after_cross = False
        if kickoff:
            x, y = L / 2.0, W / 2.0

    def turnover(loser):
        """Possession flips; breaks feed on the loser's exposure / deep loss."""
        nonlocal momentum, fast_break, hot
        e = exposure[loser]
        loser_own_goal_x = 0.0 if loser == home_team_id else L
        deep = float(np.hypot(x - loser_own_goal_x, y - W / 2.0)) < 45.0
        new_possession(other[loser])
        if deep:
            # a ball lost near one's own goal is a prime chance: the winner
            # is already in range — and how LONG the loser has been pinned
            # decides how hard the punishment hits. The pin length is the
            # k>1 concedes signal: location-only features see "deep now",
            # history sees "deep for a while and failing"
            pins = min(pin_count[loser], 6)
            momentum = 0.08 + 0.12 * pins
            hot = pins >= 2 or bool(rng.random() < 0.3)
            fast_break = fast_break or bool(rng.random() < 0.15 + 0.12 * pins)
        elif e > 0.40:
            # the loser over-committed up the pitch: the winner springs a
            # fast counter the length of the field. There is no location
            # cue here — the ball was lost in midfield or higher — so only
            # the loser's multi-action history (the long forward chain
            # that built the exposure) predicts the concede
            momentum = 0.65
            hot = True
            fast_break = True
        exposure[loser] = 0.5 * e

    def pick_player():
        attacks_right = team == home_team_id
        xa = x if attacks_right else L - x
        zone = 0 if xa < L / 3 else (1 if xa < 2 * L / 3 else 2)
        p = _ZONE_ROLE_P[zone]
        role = _ROLES[int(rng.choice(4, p=[p[r] for r in _ROLES]))]
        j = int(rng.choice([j for j in range(1, 12) if _ROLE_OF[j] == role]))
        return j, team * 1000 + j

    def resolve_shot(i, p_goal):
        nonlocal t
        goal = rng.random() < p_goal
        result_id[i] = spadlconfig.SUCCESS if goal else spadlconfig.FAIL
        if goal:
            score[team] += 1
            t += rng.uniform(30.0, 60.0)  # celebration + restart
            new_possession(other[team], kickoff=True)
        return goal

    for i in range(n):
        if i == half:  # second half: clock restarts, away kicks off
            t = 0.0
            pending = None
            exposure = {home_team_id: 0.0, away_team_id: 0.0}
            new_possession(away_team_id, kickoff=True)

        attacks_right = team == home_team_id
        goal_x = L if attacks_right else 0.0
        trailing = score[team] < score[other[team]]

        # ---- forced set-piece actions ----
        if pending == 'penalty':
            t += rng.uniform(20.0, 40.0)  # set-up time
            time_seconds[i] = t
            team_id[i] = team
            player_id[i] = team * 1000 + 11  # designated taker
            px = goal_x - 11.0 if attacks_right else goal_x + 11.0
            start_x[i], start_y[i] = px, W / 2.0
            end_x[i], end_y[i] = goal_x, W / 2.0 + rng.normal(0, 1.0)
            type_id[i] = SHOT_PENALTY
            bodypart_id[i] = FOOT
            momentum_lat[i], fast_lat[i], hot_lat[i] = momentum, False, hot
            exposure_lat[i] = exposure[team]
            goal = resolve_shot(i, PENALTY_PRIOR)
            if not goal:
                new_possession(other[team])
                x = (rng.uniform(3.0, 12.0) if team == home_team_id
                     else rng.uniform(L - 12.0, L - 3.0))
                y = rng.uniform(W * 0.3, W * 0.7)
            pending = None
            continue

        if pending == 'corner':
            t += rng.uniform(15.0, 30.0)
            time_seconds[i] = t
            team_id[i] = team
            j, pid = pick_player()
            player_id[i] = pid
            cy = 0.0 if rng.random() < 0.5 else W
            start_x[i], start_y[i] = goal_x, cy
            ex = (goal_x - rng.uniform(3.0, 10.0) if attacks_right
                  else goal_x + rng.uniform(3.0, 10.0))
            ey = float(np.clip(W / 2.0 + rng.normal(0, 6.0), 0.0, W))
            ex = float(np.clip(ex, 0.0, L))
            end_x[i], end_y[i] = ex, ey
            type_id[i] = CORNER
            bodypart_id[i] = FOOT
            momentum_lat[i], fast_lat[i], hot_lat[i] = momentum, False, hot
            exposure_lat[i] = exposure[team]
            ok = rng.random() < 0.55
            result_id[i] = spadlconfig.SUCCESS if ok else spadlconfig.FAIL
            x, y = ex, ey
            if ok:
                pending = 'corner_shot'
            else:
                pending = None
                new_possession(other[team])
            continue

        if pending == 'corner_shot':
            t += rng.uniform(1.0, 3.0)
            time_seconds[i] = t
            team_id[i] = team
            j, pid = pick_player()
            player_id[i] = pid
            start_x[i], start_y[i] = x, y
            end_x[i], end_y[i] = goal_x, W / 2.0 + rng.normal(0, 2.0)
            bp = HEAD if rng.random() < 0.75 else FOOT
            type_id[i] = SHOT
            bodypart_id[i] = bp
            momentum_lat[i], fast_lat[i], hot_lat[i] = momentum, False, hot
            exposure_lat[i] = exposure[team]
            # pinned so that P(goal | corner) = 0.55 * E[p_goal] = CORNER_PRIOR
            # (the head/foot mix cancels exactly: 0.75*0.85 + 0.25*1.45 = 1;
            # skill is excluded here, as on penalties, to keep the pin exact)
            base = CORNER_PRIOR / 0.55
            p_goal = base * (0.85 if bp == HEAD else 1.45)
            goal = resolve_shot(i, float(np.clip(p_goal, 0.01, 0.5)))
            if not goal:
                turnover(team)
                x = float(np.clip(x + rng.normal(0, 8), 0, L))
                y = float(np.clip(y + rng.normal(0, 8), 0, W))
            pending = None
            continue

        # ---- open play ----
        dist_goal = float(np.hypot(x - goal_x, y - W / 2.0))
        t += rng.uniform(1.0, 4.0) if fast_break else rng.uniform(2.0, 9.0)
        time_seconds[i] = t
        team_id[i] = team
        j, pid = pick_player()
        player_id[i] = pid
        start_x[i], start_y[i] = x, y
        momentum_lat[i], fast_lat[i], hot_lat[i] = momentum, fast_break, hot
        exposure_lat[i] = exposure[team]
        own_gx = 0.0 if attacks_right else L
        if float(np.hypot(x - own_gx, y - W / 2.0)) < 35.0:
            pin_count[team] += 1
        else:
            pin_count[team] = 0

        # shot hazard: proximity × momentum × (pressing when trailing);
        # on a fast break the shot comes EARLY, from range, because the
        # defense is unset — location-only features cannot tell these
        # high-value chances from hopeless long shots, history can
        p_shot = (
            0.12 * np.exp(-dist_goal / 11.0)
            * (1.0 + 2.5 * momentum)
            * (1.25 if trailing else 1.0)
        )
        if fast_break:
            p_shot = max(p_shot, 0.20 * np.exp(-dist_goal / 32.0))
        if after_cross and dist_goal < 18.0:
            p_shot = max(p_shot, 0.45)
        u = rng.random()
        if u < p_shot:
            a_type = SHOT
        elif u < p_shot + 0.08:
            a_type = int(rng.choice(tail_types))
        elif u < p_shot + 0.08 + (1 - p_shot - 0.08) * 0.72:
            a_type = PASS
        else:
            a_type = DRIBBLE

        wide = y < W * 0.22 or y > W * 0.78

        # movement: build-up drifts toward the attacked goal
        if a_type == SHOT:
            ex, ey = goal_x, W / 2.0 + rng.normal(0, 2.0)
            bp = HEAD if (after_cross and rng.random() < 0.6) else (
                HEAD if rng.random() < 0.04 else FOOT)
        else:
            step = (abs(rng.normal(18.0 if fast_break else 14.0, 8.0))
                    if a_type == PASS else abs(rng.normal(6.0, 3.0)))
            to_goal_x = goal_x - x
            to_goal_y = (W / 2.0 - y) * 0.4
            norm = max(float(np.hypot(to_goal_x, to_goal_y)), 1e-6)
            drift = 0.55 if not fast_break else 0.8  # breaks go forward
            ex = x + step * (drift * to_goal_x / norm + rng.normal(0, 0.6))
            ey = y + step * (drift * to_goal_y / norm + rng.normal(0, 0.6))
            bp = (HEAD if (a_type == PASS and step > 22 and rng.random() < 0.2)
                  else FOOT)
        ex = float(np.clip(ex, 0.0, L))
        ey = float(np.clip(ey, 0.0, W))
        end_dist = float(np.hypot(ex - goal_x, ey - W / 2.0))
        if a_type == PASS and wide and end_dist < 17.0 and dist_goal < 40.0:
            a_type = CROSS  # a wide delivery into the box
        end_x[i], end_y[i] = ex, ey
        type_id[i] = a_type
        bodypart_id[i] = bp

        if a_type == SHOT:
            # conversion: the *history* — not just where the shot is taken
            # from — decides whether chances convert; headers convert at
            # 0.55× and persistent skill scales everything
            skill = strength[team] * finish[team][j]
            bp_mult = 0.55 if bp == HEAD else 1.0
            if fast_break:
                p_goal = 0.16 * np.exp(-dist_goal / 28.0) * (1.0 + 2.0 * momentum)
            else:
                p_goal = 0.055 * np.exp(-dist_goal / 10.0) * (1.0 + 3.5 * momentum)
            p_goal = float(np.clip(p_goal * skill * bp_mult, 0.01, 0.55))
            goal = resolve_shot(i, p_goal)
            after_cross = False
            if not goal:
                if rng.random() < 0.2:
                    pending = 'corner'  # saved/deflected behind
                else:
                    # miss: opponent restarts deep in their own territory
                    new_possession(other[team])
                    x = (rng.uniform(L - 14.0, L - 3.0) if attacks_right
                         else rng.uniform(3.0, 14.0))
                    y = rng.uniform(W * 0.25, W * 0.75)
            continue

        # moves: success decays with attempted length, rises with momentum;
        # crosses are risky and pinned teams play under pressure
        move_len = float(np.hypot(ex - x, ey - y))
        own_goal_x = 0.0 if attacks_right else L
        pinned = float(np.hypot(x - own_goal_x, y - W / 2.0)) < 30.0
        p_success = float(np.clip(
            (0.89 - 0.011 * move_len + 0.12 * momentum) * strength[team]
            * (0.8 if a_type == CROSS else 1.0) * (0.9 if pinned else 1.0),
            0.30, 0.97,
        ))
        ok = rng.random() < p_success
        result_id[i] = spadlconfig.SUCCESS if ok else spadlconfig.FAIL
        if ok:
            forward = (ex - x) if attacks_right else (x - ex)
            # SLOW decay: the state persists across the 10-action label
            # window; hot possessions build it, cold ones plateau low
            gain = (0.10 + (0.08 if forward > 6.0 else 0.0)) if hot else 0.03
            momentum = float(np.clip(0.85 * momentum + gain, 0.0, 1.0))
            # committing players forward builds exposure over several
            # actions; it decays while the other side holds the ball
            exposure[team] = float(np.clip(
                0.93 * exposure[team] + (0.10 if forward > 6.0 else 0.01),
                0.0, 1.0))
            exposure[other[team]] = 0.95 * exposure[other[team]]
            after_cross = a_type == CROSS
            x, y = ex, ey
            if rng.random() < 0.05:  # natural possession end (ball out etc.)
                new_possession(other[team])
        else:
            after_cross = False
            x, y = ex, ey  # turnover at the failed action's end point
            in_box = (abs(ex - goal_x) < 16.5) and (abs(ey - W / 2.0) < 20.0)
            if a_type == DRIBBLE and in_box and rng.random() < 0.08:
                pending = 'penalty'  # fouled in the box; ball retained
                continue
            turnover(team)

    # clocks are strictly increasing within each period by construction
    cols = {
        'game_id': np.full(n, game_id, dtype=np.int64),
        'action_id': np.arange(n, dtype=np.int64),
        'period_id': period_id,
        'time_seconds': time_seconds,
        'team_id': team_id,
        'player_id': player_id,
        'start_x': start_x,
        'start_y': start_y,
        'end_x': end_x,
        'end_y': end_y,
        'type_id': type_id,
        'result_id': result_id,
        'bodypart_id': bodypart_id,
    }
    if include_latents:
        cols.update(zip(LATENT_COLUMNS, (momentum_lat, fast_lat, hot_lat, exposure_lat)))
    return cols


def synthetic_actions_frame(
    game_id: int = 1,
    *,
    home_team_id: int = 100,
    away_team_id: int = 200,
    n_actions: int = 1600,
    seed: int = 0,
    include_latents: bool = False,
) -> 'pd.DataFrame':
    """A schema-valid synthetic SPADL DataFrame for one game.

    Statistically plausible AND **learnable**: the generator simulates
    possession chains with the same *sequential* feature→label structure
    real soccer has, so models trained on these games must beat chance on
    held-out games (the air-gapped stand-in for the reference's real-data
    quality tier — see QUALITY.md), and history-aware features must beat
    location-only features on BOTH label heads (the ablation tiers):

    - **ball continuity**: each action starts where the previous one
      ended; a turnover hands the ball to the other team *at that spot*;
    - **possession quality** (``hot``): each possession is a hot attack
      (~22%) or cold circulation. Hot possessions build momentum (which
      multiplies move success, shot hazard and conversion); cold ones
      plateau low. The quality is hidden but telegraphed through the
      recent history — successes, forward progress, tempo — exactly what
      the ``team``/``time_delta``/``space_delta`` context transformers
      and k>1 state copies expose;
    - **fast breaks**: half the hot possessions (and most possessions won
      off a deep loss) play at counterattack tempo with shots from range
      that location-only features cannot tell from hopeless long shots;
    - **defensive exposure**: sustained forward commitment builds a
      per-team exposure latent; losing the ball over-committed
      (exposure > 0.40) springs a fast counter the other way, so a
      team's own recent long forward ``space_delta`` chain predicts
      *conceding* — the planted signal behind the concedes-head
      ablation;
    - **set pieces with the formula's priors**: failed dribbles in the
      box draw penalties converted at ``PENALTY_PRIOR`` (0.792453) and
      saved shots/corner situations yield ``corner_crossed`` sequences
      whose total conversion is pinned to ``CORNER_PRIOR`` (0.0465) —
      the constants the VAEP formula replaces prev-action xG with
      (reference ``socceraction/vaep/formula.py:61-66``);
    - **bodyparts**: corner and cross deliveries are finished by headers
      (0.55× the foot conversion), long passes are sometimes headed on,
      so ``bodypart_id`` carries real signal;
    - **persistent skill**: team strength and per-player finishing are
      pure functions of the ids (:func:`_team_strength`,
      :func:`_player_finish`), stable across games — and correlated with
      observables because forwards both finish better and act in the
      attacking third;
    - **score effects**: a trailing team presses (higher shot hazard),
      giving the ``goalscore`` feature forward-looking signal.

    Measured ceilings and the committed-season numbers live in
    QUALITY.md; the executable floors in
    ``tests/test_quality_synthetic.py``.

    The loop is :func:`_chain_columns`; this wrapper adds
    ``original_event_id`` (``synth-<game>-<i>``) and builds the frame.
    """
    import pandas as pd

    cols = _chain_columns(
        game_id, home_team_id=home_team_id, away_team_id=away_team_id,
        n_actions=n_actions, seed=seed, include_latents=include_latents,
    )
    frame = pd.DataFrame({
        'game_id': cols['game_id'],
        'original_event_id': [f'synth-{game_id}-{i}' for i in range(len(cols['game_id']))],
        **{c: cols[c] for c in CHAIN_COLUMNS[1:]},
    })
    if include_latents:
        # the generator's hidden state at each action, for diagnostics and
        # the ablation tier's oracle ceiling (NOT part of the SPADL schema;
        # drop before passing to converters/stores)
        for c in LATENT_COLUMNS:
            frame[c] = cols[c]
    return frame


def write_synthetic_season(
    path: str,
    n_games: int = 3072,
    n_actions: int = 1600,
    *,
    seed: int = 0,
) -> str:
    """Write an ``n_games`` synthetic season to a :class:`SeasonStore`.

    The throughput companion of the per-game chain generator: draws the
    whole season's SPADL columns **vectorized across games** (the same
    marginal distributions as :func:`synthetic_batch`) and writes per-game
    frames under the reference store layout (one ``actions/game_<id>`` key
    per game plus ``games``/``teams``/``players`` and the vocab tables —
    the reference's ``tests/datasets/download.py:63-125``). The chain
    generator simulates every action in a Python loop; this writer draws
    the season in a few vectorized calls, for IO and throughput runs whose
    point is the *read → pack → rate* path. Quality runs use the chain
    generator.

    Games all have exactly ``n_actions`` valid actions. Returns ``path``.
    """
    import pandas as pd

    from ..pipeline.store import SeasonStore

    rng = np.random.default_rng(seed)
    G, A = n_games, n_actions
    cols = _draw_spadl_columns(rng, G, A, np.float64, np.int64)

    game_ids = 9000 + np.arange(G)
    home = 100 + 2 * (np.arange(G) % 16)
    away = home + 1
    # home/away alternate per action; player drawn from the acting team
    team_id = np.where(cols['is_home'], home[:, None], away[:, None]).astype(np.int64)
    player_id = team_id * 1000 + rng.integers(1, 12, size=(G, A))
    action_id = np.arange(A, dtype=np.int64)

    games, teams, players = [], {}, []
    with SeasonStore(path, mode='w') as store:
        store.put('actiontypes', spadlconfig.actiontypes_df())
        store.put('results', spadlconfig.results_df())
        store.put('bodyparts', spadlconfig.bodyparts_df())
        for i in range(G):
            gid = int(game_ids[i])
            frame = pd.DataFrame(
                {
                    'game_id': np.full(A, gid, dtype=np.int64),
                    'action_id': action_id,
                    'period_id': cols['period_id'][i],
                    'time_seconds': cols['time_seconds'][i],
                    'team_id': team_id[i],
                    'player_id': player_id[i],
                    'start_x': cols['start_x'][i],
                    'start_y': cols['start_y'][i],
                    'end_x': cols['end_x'][i],
                    'end_y': cols['end_y'][i],
                    'type_id': cols['type_id'][i],
                    'result_id': cols['result_id'][i],
                    'bodypart_id': cols['bodypart_id'][i],
                }
            )
            store.put_actions(gid, frame)
            games.append(
                {
                    'game_id': gid,
                    'home_team_id': int(home[i]),
                    'away_team_id': int(away[i]),
                }
            )
            for t in (int(home[i]), int(away[i])):
                teams[t] = {'team_id': t, 'team_name': f'Team {t}'}
        for t in teams:
            players.extend(
                {
                    'team_id': t,
                    'player_id': t * 1000 + j,
                    'player_name': f'Player {t}-{j}',
                    'minutes_played': 90,
                }
                for j in range(1, 12)
            )
        store.put('games', pd.DataFrame(games))
        store.put('teams', pd.DataFrame(list(teams.values())))
        store.put('players', pd.DataFrame(players))
        store.put('meta', pd.DataFrame({'synthetic': [True]}))
    return path


def append_synthetic_games(
    path: str,
    n_games: int = 4,
    *,
    n_actions: int = 300,
    seed: int = 0,
    start_id: Optional[int] = None,
) -> List[int]:
    """Land ``n_games`` new synthetic matches in an *existing* store.

    The stand-in for a live data pipeline delivering played
    matches: per-game frames come from the learnable chain generator
    (:func:`synthetic_actions_frame`) and the ``games`` table is extended
    in place — exactly the append-only mutation the continuous-learning
    loop (:mod:`socceraction_tpu_torch.learn`) watches for. Returns the new
    game ids (``start_id`` defaults past the largest stored id).
    """
    import pandas as pd

    from ..pipeline.store import SeasonStore

    with SeasonStore(path, mode='a') as store:
        games = store.games()
        existing = set(store.game_ids())
        if start_id is None:
            numeric = [int(g) for g in existing if str(g).lstrip('-').isdigit()]
            start_id = max(numeric) + 1 if numeric else 1
        new_rows = []
        gid = int(start_id)
        for j in range(int(n_games)):
            while gid in existing:
                gid += 1
            home = 100 + 2 * (j % 16)
            away = home + 1
            frame = synthetic_actions_frame(
                gid, home_team_id=home, away_team_id=away,
                n_actions=n_actions, seed=seed + j,
            )
            store.put_actions(gid, frame)
            new_rows.append(
                {'game_id': gid, 'home_team_id': home, 'away_team_id': away}
            )
            existing.add(gid)
            gid += 1
        store.put(
            'games',
            pd.concat([games, pd.DataFrame(new_rows)], ignore_index=True),
        )
    return [r['game_id'] for r in new_rows]
