"""The control and every fault a cell can have make ``correct`` false:
the run goes on past the look for a chip (on the CPU, at a small size)
with the timed path broken underneath."""

import pytest

from portbench import harness

FAULTS = [
    ('lgcn-book.train', 'control'),
    ('lgcn-book.train', 'unchanged'),
    ('lgcn-book.train', 'half_batch'),
    ('adv-book.train', 'control'),
    ('adv-book.train', 'unchanged'),
    ('adv-book.train', 'half_batch'),
    ('adv-book.train', 'answer_altered'),
    ('lgcn-book.serve', 'control'),
    ('lgcn-book.serve', 'unchanged'),
    ('lgcn-book.serve', 'half_batch'),
    ('lgcn-book.serve', 'answer_altered'),
    ('lgcn-book.serve-approx', 'control'),
    ('lgcn-book.serve-approx', 'unchanged'),
    ('lgcn-book.serve-approx', 'half_batch'),
    ('lgcn-book.serve-approx', 'answer_altered'),
]


@pytest.mark.parametrize('cell,mode', FAULTS)
def test_fault_is_not_correct(tmp_path, small, cell, mode):
    r = harness.run(cell, 31, 0.3, False, device='cpu', mode=mode,
                    overrides=small, cache_dir=str(tmp_path))
    assert not r['correct'], r['checks']
    over = [k for k, c in r['checks'].items() if c['value'] > c['limit']]
    assert over, r['checks']


def test_lgcn_has_no_altered_answer_to_plant(tmp_path, small):
    with pytest.raises(ValueError, match='no fault'):
        harness.run('lgcn-book.train', 31, 0.3, False, device='cpu',
                    mode='answer_altered', overrides=small,
                    cache_dir=str(tmp_path))


# more items than the 1,000 candidates, so the candidate mask is a draw
WIDE = dict(n_users=300, n_items=3000, n_interactions=12000)


@pytest.mark.parametrize('mode', [None, 'candidates_all',
                                  'candidates_fixed', 'positives_fixed'])
def test_adv_draws_are_judged(tmp_path, small, mode):
    """A sound run's candidate masks and positive draws pass (its other
    numbers are held to the full-size cell's limits on the card); a sampler
    that marks every item a candidate, gives every user the same ones or
    always draws the same positive fails ``sample_bad``."""
    r = harness.run('adv-book.train', 33, 0.3, False, device='cpu',
                    mode=mode, overrides=dict(small, **WIDE),
                    cache_dir=str(tmp_path))
    bad = r['checks']['sample_bad']['value']
    if mode is None:
        assert bad == 0, r['checks']
    else:
        assert not r['correct'] and bad > 0, r['checks']
