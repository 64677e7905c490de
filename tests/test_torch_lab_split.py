"""L1's decomposition on the host (``textgcn_tpu_torch.tools.kernel_lab``).

The CUDA kernel (``csrc/spmm_lab.cu``) runs only on the card; here its
mirror is held to what it must compute: the cluster's CTAs own every row
of a destination block once, the stages and warp shares read every slot
once from its own chunk's source block, the epochs never overflow, the
walk covers every row once, and the function computed that way equals
``spmm_lab_plain`` (atol = rtol = 1e-5: f32 sums in another order) in
every mode, on layouts with an edgeless block, at group 1, 3 and 8 and
d = 64 and 128.  The wrapper's refusals are checked on CPU tensors.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from textgcn_tpu_torch.tools import kernel_lab as tkl
from textgcn_tpu_torch.tools.lab_layout import tile_layout

TOL = 1e-5
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'textgcn_tpu_torch', 'csrc', 'spmm_lab.cu')
GROUPS = (1, 3, 8)


def _graph():
    """2,800 edges with duplicate pairs, 1,300 sources (3 blocks), 2,100
    destinations (5 blocks), no edge into block 2 (rows 1,024-1,535)."""
    rng = np.random.RandomState(3)
    n_src, n_dst, e = 1_300, 2_100, 2_500
    src = rng.randint(0, n_src, e)
    dst = rng.randint(0, n_dst - 512, e)
    dst[dst >= 1024] += 512
    src = np.concatenate([src, src[:300]])
    dst = np.concatenate([dst, dst[:300]])
    w = rng.rand(len(src)).astype(np.float32)
    return src, dst, w, n_src, n_dst


@pytest.fixture(scope='module', params=GROUPS, ids=lambda g: f'group{g}')
def layout(request):
    src, dst, w, n_src, n_dst = _graph()
    lay = tile_layout(src, dst, w, n_src, n_dst, group=request.param)
    assert lay.group_ptr[3] == lay.group_ptr[2]     # the edgeless block
    return lay.to('cpu')


def test_config_mirrors_the_kernel_source():
    """The host's constants are the source's (the loaded library is held
    to CONFIG again on the card)."""
    with open(SOURCE) as f:
        text = f.read()

    def const(name):
        m = re.search(rf'constexpr int {name} = (\d+);', text)
        assert m, name
        return int(m.group(1))
    assert (const('kCluster'), const('kConsumerWarps'), const('kStageSlots'),
            const('kStages'), const('kCap'), const('kRowBits')) == (
        tkl.CLUSTER, tkl.CONSUMER_WARPS, tkl.STAGE_SLOTS, tkl.STAGES,
        tkl.CAP, tkl.ROW_BITS)
    assert 'sizeof(T) == 4 ? 4 : 8' in text
    assert (tkl.ROUNDS[torch.float32], tkl.ROUNDS[torch.bfloat16]) == (4, 8)
    assert '__cluster_dims__(kCluster, 1, 1)' in text
    assert 2 ** tkl.ROW_BITS == tkl.TILE_ROWS == 512 // tkl.CLUSTER
    # two CTAs an SM (232,448 bytes, 1 KB reserved a CTA) for one wave
    assert 2 * (tkl.SMEM_BYTES + 1024) <= 232_448
    assert tkl.CONFIG[-1] == tkl.SMEM_BYTES


def test_cluster_rows_partition_a_block():
    rows = np.concatenate([tkl.cta_rows(r) for r in range(tkl.CLUSTER)])
    np.testing.assert_array_equal(np.sort(rows), np.arange(512))
    for r in range(tkl.CLUSTER):
        assert (tkl.cta_rows(r) % tkl.CLUSTER == r).all()
        assert len(tkl.cta_rows(r)) == tkl.TILE_ROWS
    # no_scatter's rows (the slots of a chunk) reach every CTA alike
    first = [np.isin(tkl.cta_rows(r), np.arange(128)).sum()
             for r in range(tkl.CLUSTER)]
    assert first == [128 // tkl.CLUSTER] * tkl.CLUSTER
    with pytest.raises(ValueError, match='rank'):
        tkl.cta_rows(tkl.CLUSTER)


def test_work_split_reads_every_slot_once(layout):
    split = tkl.work_split(layout)
    n = layout.n_slots
    slot = np.arange(n)
    share = tkl.STAGE_SLOTS // tkl.CONSUMER_WARPS
    key = (split['block'] * 10_000 + split['stage']) * 100 + split['warp']
    _, first, count = np.unique(key, return_index=True, return_counts=True)
    # shares are runs of consecutive slots, none longer than a warp's
    assert count.sum() == n and (count <= share).all()
    assert (np.diff(np.sort(first)) > 0).all()
    # a warp's share lies in one chunk: its source block is every slot's
    np.testing.assert_array_equal(split['chunk'], slot // layout.chunk)
    gp = layout.group_ptr.numpy().astype(np.int64)
    slots = np.diff(gp) * layout.group * layout.chunk
    np.testing.assert_array_equal(split['n_stages'],
                                  -(-slots // tkl.STAGE_SLOTS))
    assert split['n_stages'][2] == 0 and not (split['block'] == 2).any()
    for b in range(layout.n_dst_blocks):
        stages = split['stage'][split['block'] == b]
        assert (stages < split['n_stages'][b]).all()
        assert len(stages) == slots[b]


@pytest.mark.parametrize('kept', [[], [0], [181] * 14, [300] * 14,
                                  [512] * 20, [7, 512, 0, 511, 512] * 4],
                         ids=['empty', 'none-kept', 'lab', 'dense',
                              'full', 'mixed'])
def test_epochs_take_every_stage_once_and_never_overflow(kept):
    epochs = tkl.epoch_stages(kept)
    stages = [n for run in epochs for n in run]
    assert stages == list(range(len(kept)))
    assert len(epochs) >= 1
    for run in epochs:
        assert sum(kept[n] for n in run) <= tkl.CAP
    if sum(kept) <= tkl.CAP - tkl.STAGE_SLOTS:
        assert len(epochs) == 1


@pytest.mark.parametrize('counts', ['poisson', 'one-hot-row', 'empty',
                                    'first-128'])
def test_walk_covers_every_row_once(counts):
    rng = np.random.RandomState(5)
    c = {'poisson': rng.poisson(10, tkl.TILE_ROWS),
         'one-hot-row': np.eye(1, tkl.TILE_ROWS, 7)[0] * 5000,
         'empty': np.zeros(tkl.TILE_ROWS),
         'first-128': np.concatenate([rng.poisson(40, 64),
                                      np.zeros(tkl.TILE_ROWS - 64)])}[counts]
    c = c.astype(np.int64)
    bounds = tkl.walk_rows(c)
    assert len(bounds) == tkl.WALKERS + 1
    assert bounds[0] == 0 and bounds[-1] == tkl.TILE_ROWS
    assert (np.diff(bounds) >= 0).all()
    # a walker's slots: at most its share and one row more
    starts = np.concatenate([[0], np.cumsum(c)])
    share = -(-int(c.sum()) // tkl.WALKERS)
    for k in range(tkl.WALKERS):
        assert starts[bounds[k + 1]] - starts[bounds[k]] <= share + c.max()


@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('xd', ['f32', 'bf16'])
def test_spmm_lab_split_equals_plain(layout, d, xd):
    dtype = {'f32': torch.float32, 'bf16': torch.bfloat16}[xd]
    x = torch.from_numpy(np.random.RandomState(d).randn(
        layout.n_src_padded, d).astype(np.float32)).to(dtype)
    for mode in tkl.MODES:
        want = tkl.spmm_lab_plain(layout, x, mode)
        got = tkl.spmm_lab_split(layout, x, mode)
        assert got.shape == want.shape == (layout.n_dst_blocks * 512, d)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=mode)
        assert not got[1024:1536].any()     # the edgeless block


def test_wrapper_refusals(layout):
    x = torch.zeros(layout.n_src_padded, 128)
    tkl.check_kernel_args(layout, x)                # d = 128: two slices
    with pytest.raises(ValueError, match='multiple of 64'):
        tkl.check_kernel_args(layout, torch.zeros(layout.n_src_padded, 96))
    flat = torch.zeros(layout.n_src_padded * 64 + 1)
    with pytest.raises(ValueError, match='16-byte aligned'):
        tkl.check_kernel_args(layout,
                              flat[1:].view(layout.n_src_padded, 64))
    with pytest.raises(ValueError, match='16-byte aligned'):
        tkl.check_kernel_args(layout, x[:, :64])    # not contiguous
    with pytest.raises(ValueError, match='int32'):
        tkl.check_kernel_args(dataclasses.replace(
            layout, chunk_sb=layout.chunk_sb.long()), x)
    before = tkl.spmm_lab_cuda.launches
    with pytest.raises(ValueError, match='CUDA'):
        tkl.spmm_lab_cuda(layout, x[:, :64].contiguous(), 'full')
    assert tkl.spmm_lab_cuda.launches == before

