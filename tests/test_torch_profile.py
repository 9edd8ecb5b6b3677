"""The port's rating-path profile (``ops/profile.py``) against the JAX
package's rules.

The resolution order (env override, then the platform's entry, then
``'fused'``), the env values and their errors, an unmeasured platform, a
missing, an unreadable and a hand-edited profile file, and
``record_measurement`` deriving the winner, each checked against the JAX
package's ``preferred_rating_path`` on the same file where both can read
it. The committed file holds one entry, ``cuda``, which must be a
measurement of both paths that names its card and its chip run.
"""

import json
import re

import pytest
import torch

from socceraction_tpu.ops import profile as jprofile
from socceraction_tpu_torch.ops import profile as tprofile

ENV = 'SOCCERACTION_TPU_RATING_PATH'


@pytest.fixture
def profile_file(tmp_path, monkeypatch):
    """Both modules read a temporary profile file, with fresh caches."""
    path = tmp_path / 'platform_profiles.json'
    monkeypatch.setattr(tprofile, '_PROFILE_FILE', str(path))
    monkeypatch.setattr(jprofile, '_PROFILE_FILE', str(path))
    monkeypatch.setattr(tprofile, '_cache', {})
    monkeypatch.setattr(jprofile, '_cache', {})
    monkeypatch.delenv(ENV, raising=False)
    return path


def _both(platform, **kw):
    return tprofile.preferred_rating_path(platform, **kw), jprofile.preferred_rating_path(
        platform, **kw
    )


def test_names_match_jax():
    assert tprofile.RATING_PATHS == jprofile.RATING_PATHS
    assert tprofile.OPT_IN_PATHS == jprofile.OPT_IN_PATHS
    assert set(tprofile.FUSED_PATH_HIDDEN_DTYPES) == set(jprofile.FUSED_PATH_HIDDEN_DTYPES)
    assert tprofile.hidden_dtype_for('fused') is None
    assert tprofile.hidden_dtype_for('fused_bf16') == torch.bfloat16
    with pytest.raises(KeyError):
        tprofile.hidden_dtype_for('materialized')


def test_resolution_order(profile_file, monkeypatch):
    """The platform's entry, unless the env forces a path; 'auto' and an
    empty value defer to the entry; respect_env=False ignores the env."""
    tprofile.record_measurement('gpu', 1.0, 2.0, source='t')
    jprofile.record_measurement('gpu', 1.0, 2.0, source='t')
    assert _both('gpu') == ('materialized', 'materialized')
    for value in ('auto', '', ' AUTO '):
        monkeypatch.setenv(ENV, value)
        assert _both('gpu') == ('materialized', 'materialized')
    for value in ('fused', 'fused_bf16', 'materialized', ' Fused '):
        monkeypatch.setenv(ENV, value)
        assert _both('gpu') == (value.strip().lower(),) * 2
        assert _both('gpu', respect_env=False) == ('materialized', 'materialized')


def test_invalid_env_value_raises(profile_file, monkeypatch):
    monkeypatch.setenv(ENV, 'pallas')
    with pytest.raises(ValueError, match=ENV):
        tprofile.preferred_rating_path('cuda')
    with pytest.raises(ValueError, match=ENV):
        jprofile.preferred_rating_path('cuda')
    assert tprofile.preferred_rating_path('cuda', respect_env=False) in tprofile.RATING_PATHS


def test_unmeasured_platform_is_fused(profile_file):
    tprofile.record_measurement('gpu', 1.0, 2.0, source='t')
    jprofile.record_measurement('gpu', 1.0, 2.0, source='t')
    assert _both('rocm') == ('fused', 'fused')


@pytest.mark.parametrize('content', [None, '{not json'], ids=['missing', 'corrupt'])
def test_unreadable_profile_is_fused(profile_file, content):
    if content is not None:
        profile_file.write_text(content)
    assert _both('cuda') == ('fused', 'fused')
    # and the file is not opened again on the next call
    profile_file.write_text(json.dumps({'platforms': {'cuda': {'rating_path': 'materialized'}}}))
    assert tprofile.preferred_rating_path('cuda') == 'fused'


def test_hand_edited_profile_raises(profile_file):
    profile_file.write_text(json.dumps({'platforms': {'cuda': {'rating_path': 'fused_bf16'}}}))
    with pytest.raises(ValueError, match='invalid rating_path'):
        tprofile.preferred_rating_path('cuda')
    with pytest.raises(ValueError, match='invalid rating_path'):
        jprofile.preferred_rating_path('cuda')


@pytest.mark.parametrize('rates,winner', [((3.0, 2.0), 'fused'), ((2.0, 3.0), 'materialized'),
                                          ((2.0, 2.0), 'fused')])
def test_record_measurement_derives_the_winner(profile_file, rates, winner):
    entry = tprofile.record_measurement('cuda', *rates, source='run 1', device_kind='card, 1 W')
    want = jprofile.record_measurement('cuda', *rates, source='run 1', device_kind='card, 1 W')
    assert entry == want and entry['rating_path'] == winner
    # the cache is refreshed: the next call reads the new entry
    assert tprofile.preferred_rating_path('cuda') == winner
    on_disk = json.loads(profile_file.read_text())
    assert on_disk['platforms']['cuda'] == entry


def test_record_measurement_keeps_other_platforms(profile_file):
    tprofile.record_measurement('cuda', 3.0, 2.0, source='a')
    tprofile.record_measurement('cpu', 1.0, 2.0, source='b')
    got = tprofile.load_profiles()['platforms']
    assert set(got) == {'cuda', 'cpu'}
    assert (got['cuda']['rating_path'], got['cpu']['rating_path']) == ('fused', 'materialized')


def test_committed_profile_is_a_card_measurement():
    """The committed file holds the cuda entry alone, written by
    record_measurement from a chip run of both paths: the winner follows
    from the two rates, the card's name and power limit are given, and the
    source names the run."""
    with open(tprofile._PROFILE_FILE) as f:
        profiles = json.load(f)
    assert set(profiles) == {'platforms'}
    assert set(profiles['platforms']) == {'cuda'}
    entry = profiles['platforms']['cuda']
    fused, mat = entry['fused_actions_per_sec'], entry['materialized_actions_per_sec']
    assert fused > 0 and mat > 0
    assert entry['rating_path'] == ('fused' if fused >= mat else 'materialized')
    assert re.fullmatch(r'NVIDIA .+, \d+\.\d\d W', entry['device_kind'])
    assert 'chip_smoke.py' in entry['source'] and re.search(r'chip call \d+', entry['source'])
