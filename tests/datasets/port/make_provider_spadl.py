"""Write ``provider_spadl.json``: the SPADL actions of each provider fixture game.

Six layouts of the hand-built fixture games go through their loader and
their SPADL converter: Opta XML (F7 + F24), Opta JSON (F1 + F9 + F24),
StatsPerform (MA1 + MA3), WhoScored, the Wyscout public release and the
Wyscout API (v2). The file maps each layout to its game's
``home_team_id`` and the SPADL columns of its actions (every column but
the provider's own ``original_event_id``), as lists.

The GPU smoke's provider phase reads the file with ``json`` (the card's
machine has no pandas) and rates the games; ``tests/test_torch_data_opta.py``
holds it equal to what both packages' loaders and converters give.

Run from the repository root: ``python tests/datasets/port/make_provider_spadl.py``
"""

from __future__ import annotations

import importlib
import json
import os
import sys
from typing import Any, Dict, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
DATASETS = os.path.dirname(HERE)
PATH = os.path.join(HERE, 'provider_spadl.json')

#: The SPADL columns the file holds, in order.
COLUMNS = (
    'game_id', 'action_id', 'period_id', 'time_seconds', 'team_id', 'player_id', 'start_x',
    'start_y', 'end_x', 'end_y', 'type_id', 'result_id', 'bodypart_id',
)


def layouts(package: str) -> Dict[str, Tuple[Any, Any, Any, str]]:
    """Each layout's loader (from ``package``'s ``data``), its competition
    and season ids and its converter's name under ``package.spadl``."""
    opta = importlib.import_module(f'{package}.data.opta')
    wyscout = importlib.import_module(f'{package}.data.wyscout')
    root = os.path.join(DATASETS, 'opta')
    return {
        'opta_xml': (opta.OptaLoader(root=root, parser='xml', feeds={
            'f7': 'f7-{competition_id}-{season_id}-{game_id}.xml',
            'f24': 'f24-{competition_id}-{season_id}-{game_id}.xml',
        }), 8, 2017, 'opta'),
        'opta_json': (opta.OptaLoader(root=root, parser='json', feeds={
            'f1': 'tournament-{season_id}-{competition_id}.json',
            'f9': 'f7-{competition_id}-{season_id}-{game_id}.json',
            'f24': 'f7-{competition_id}-{season_id}-{game_id}.json',
        }), 8, 2017, 'opta'),
        'statsperform': (opta.OptaLoader(root=os.path.join(DATASETS, 'statsperform'),
                                         parser='statsperform'), '8', '2017', 'opta'),
        'whoscored': (opta.OptaLoader(root=os.path.join(DATASETS, 'whoscored'), parser='whoscored'),
                      8, 2017, 'opta'),
        'wyscout_public': (wyscout.PublicWyscoutLoader(
            root=os.path.join(DATASETS, 'wyscout_public', 'raw'), download=False), 28, 10078, 'wyscout'),
        'wyscout_api': (wyscout.WyscoutLoader(root=os.path.join(DATASETS, 'wyscout_api'), getter='local', feeds={
            'competitions': 'competitions.json',
            'seasons': 'seasons_{competition_id}.json',
            'events': 'events_{game_id}.json',
        }), 77, 2021, 'wyscout'),
    }


def provider_actions(package: str) -> Dict[str, Tuple[Any, Any]]:
    """``(home_team_id, actions)`` of each layout's one game: ``package``'s
    loader, then its ``convert_to_actions``."""
    out = {}
    for layout, (loader, competition_id, season_id, provider) in layouts(package).items():
        game = loader.games(competition_id, season_id).iloc[0]
        convert = importlib.import_module(f'{package}.spadl.{provider}').convert_to_actions
        out[layout] = (game['home_team_id'], convert(loader.events(game['game_id']), game['home_team_id']))
    return out


def provider_record(home_team_id: Any, actions: Any) -> Dict[str, Any]:
    """One layout's entry of the file."""
    return {
        'home_team_id': home_team_id.item() if hasattr(home_team_id, 'item') else home_team_id,
        'actions': {c: actions[c].tolist() for c in COLUMNS},
    }


def main() -> None:
    record = {layout: provider_record(home, actions)
              for layout, (home, actions) in provider_actions('socceraction_tpu_torch').items()}
    # one line a column
    layouts_json = []
    for layout, r in record.items():
        columns = ',\n'.join(f'   {json.dumps(c)}: {json.dumps(v)}' for c, v in r['actions'].items())
        layouts_json.append(f' {json.dumps(layout)}: {{\n  "home_team_id": {json.dumps(r["home_team_id"])},\n'
                            f'  "actions": {{\n{columns}\n  }}\n }}')
    with open(PATH, 'w') as fh:
        fh.write('{\n' + ',\n'.join(layouts_json) + '\n}\n')
    with open(PATH) as fh:
        assert json.load(fh) == record
    print({layout: len(r['actions']['game_id']) for layout, r in record.items()})


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(DATASETS)))
    main()
