"""The benchmark's own tests: CPU at small sizes, except those marked
``card``, which skip without a CUDA device (decided inside the test)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the cells at a size the CPU runs in seconds
SMALL = dict(n_users=300, n_items=500, n_interactions=6000, batch_size=64,
             cohort_min=8, cohort_max=128, pool_requests=64,
             check_requests=8, kept_rows=4, trace_steps=4, cohort_grid=4,
             warmup_steps=2, warmup_requests=2)


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA device')


@pytest.fixture
def small():
    return dict(SMALL)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda:0')
