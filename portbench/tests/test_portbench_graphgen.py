import numpy as np

from portbench import graphgen

DATASET = dict(n_users=2000, n_items=3000, n_interactions=60000,
               popularity_exponent=0.5, train_share=0.8, graph_seed=5)


def test_same_seed_same_pairs_other_seed_other_pairs():
    a = graphgen.generate(DATASET)
    b = graphgen.generate(DATASET)
    c = graphgen.generate(dict(DATASET, graph_seed=2**31 + 7))
    for f in ('train_user', 'train_item', 'test_user', 'test_item'):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.train_item, c.train_item)


def test_count_distinct_and_split():
    inter = graphgen.generate(dict(DATASET, graph_seed=1))
    u = np.concatenate([inter.train_user, inter.test_user])
    i = np.concatenate([inter.train_item, inter.test_item])
    keys = u * DATASET['n_items'] + i
    assert len(np.unique(keys)) == len(keys) == DATASET['n_interactions']
    deg = np.bincount(u, minlength=DATASET['n_users'])
    tdeg = np.bincount(inter.test_user, minlength=DATASET['n_users'])
    np.testing.assert_array_equal(tdeg, np.minimum(
        np.floor(0.2 * deg + 0.5), deg - 1))
    assert (np.bincount(inter.train_user) >= 1).all()


def test_degrees_follow_the_power_law():
    """Heavier ranks carry more pairs: the top 1% of items hold far more
    than 1% of the pairs, and the heaviest rows are many times the mean."""
    inter = graphgen.generate(dict(DATASET, graph_seed=3))
    s = graphgen.degree_stats(inter)
    assert s['pairs'] == DATASET['n_interactions']
    assert s['top1pct_item_share'] > 0.05
    assert s['max_item_degree'] > 4 * s['mean_item_degree']
    assert s['max_user_degree'] > 4 * s['mean_user_degree']


def test_rank_cdf_matches_the_exponent():
    cdf = graphgen.rank_cdf(4, 0.5)
    w = np.arange(1, 5) ** -0.5
    np.testing.assert_allclose(np.diff(cdf, prepend=0), w / w.sum())


def test_tsv_round_trip_and_cache(tmp_path):
    small = dict(DATASET, n_interactions=5000)
    folder, inter, gen_s = graphgen.materialise(small, str(tmp_path))
    assert gen_s > 0
    u, i = graphgen.parse_tsv(f'{folder}/train.tsv')
    np.testing.assert_array_equal(u, inter.train_user)
    np.testing.assert_array_equal(i, inter.train_item)
    with open(f'{folder}/train.tsv', 'rb') as f:
        head = f.read(30)
    assert head.startswith(b'user_id\tasin\nu')
    again, inter2, gen2 = graphgen.materialise(small, str(tmp_path))
    assert again == folder and gen2 == 0.0
    np.testing.assert_array_equal(inter2.test_item, inter.test_item)
