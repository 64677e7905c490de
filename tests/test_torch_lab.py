"""The port's labs (``textgcn_tpu_torch.tools``) against the JAX labs.

The JAX labs (``tools/kernel_lab.py``, ``tools/gather_lab.py``) run
unmodified in TPU interpret mode on the CPU, at small shapes set through
their module globals.  The port's plain versions must give the TPU
kernels' outputs: the tiled SpMM's five modes within atol = rtol = 1e-5
(f32 sums in another order), the gathers bit for bit.  The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here their wrappers
must refuse CPU tensors.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from helpers.torch_native import ensure_jax_native  # noqa: E402
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu import native  # noqa: E402
from textgcn_tpu.ops import pallas_spmm  # noqa: E402
from textgcn_tpu_torch.tools import gather_lab as tgl  # noqa: E402
from textgcn_tpu_torch.tools import kernel_lab as tkl  # noqa: E402
from textgcn_tpu_torch.tools.lab_layout import (block_padded_ids,  # noqa: E402
                                                 tile_layout)
from tools import gather_lab as jgl  # noqa: E402
from tools import kernel_lab as jkl  # noqa: E402

TOL = 1e-5
# L1: 3,000 edges, 700 sources (2 blocks) -> 1,100 destinations (3 blocks)
E, NI, NU, D = 3_000, 700, 1_100, 8
# L2 and L3: ids into 1,500 rows (3 source blocks); L3 keeps 1,000 ids,
# cut to 896 (7 chunks of 128)
G_SRC, G_D, G_ROWS, G_DMA = 1_500, 8, 2_000, 1_000
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}
L1_CASES = [(xd, mode, 8) for xd in DTYPES for mode in tkl.MODES] + \
    [('f32', 'full', 4)]


def _as_f32(a) -> np.ndarray:
    return np.asarray(a.astype(jax.numpy.float32))


@pytest.fixture(scope='module')
def labs():
    """The JAX labs' outputs and inputs, and the port's inputs drawn from
    its own streams; every JAX call in TPU interpret mode."""
    res = {'l1': {}}
    with pytest.MonkeyPatch.context() as mp:
        rng = np.random.RandomState(0)
        for name, v in (('E', E), ('NI', NI), ('NU', NU), ('D', D)):
            mp.setattr(jkl, name, v)
            mp.setattr(tkl, name, v)
        mp.setattr(jkl, 'SRC', rng.randint(0, NI, E).astype(np.int32))
        mp.setattr(jkl, 'DST', rng.randint(0, NU, E).astype(np.int32))
        mp.setattr(jkl, 'W', rng.rand(E).astype(np.float32))
        mp.setattr(jkl, 'rng', rng)
        src, dst, w, port_rng = tkl.lab_graph()
        res['graph'] = (src, dst, w)
        for xd, mode, group in L1_CASES:
            mp.setenv('TEXTGCN_TPU_LAB_XDTYPE', xd)
            mp.setattr(pallas_spmm, 'GROUP', group)
            layout = tile_layout(src, dst, w, NI, NU, group=group)
            port_x = tkl.lab_x(port_rng, layout.n_src_padded, tkl.x_dtype())
            with pltpu.force_tpu_interpret_mode():
                call, xj, _ = jkl.make_variant(mode,
                                               jax.lax.Precision.HIGHEST)
                out = np.asarray(call(xj))
            res['l1'][xd, mode, group] = (layout, port_x, _as_f32(xj),
                                          str(xj.dtype), out)

        mp.setattr(jgl, 'N_SRC', G_SRC)
        mp.setattr(jgl, 'D', G_D)
        ids = np.random.RandomState(1).randint(0, G_SRC, G_ROWS) \
            .astype(np.int32)
        x_rng = np.random.RandomState(2)
        x8 = x_rng.randn(-(-G_SRC // 512) * 512, G_D).astype(np.float32)
        x128 = x_rng.randn(-(-G_SRC // 512) * 512, 128).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            call, _ = jgl.make_onehot(np.sort(ids))
            onehot = np.asarray(call(x8))
            call, _ = jgl.make_dma(ids[:G_DMA])
            dma = np.asarray(call(x128))
        res['l2'] = (ids, x8, onehot)
        res['l3'] = (ids[:G_DMA], x128, dma)
    return res


# --- (a) the layout ---------------------------------------------------------

def _layout_graph():
    """Edges with duplicate pairs and no edge into destination block 2
    (rows 1,024-1,535) of five; three source blocks."""
    rng = np.random.RandomState(3)
    n_src, n_dst, e = 1_300, 2_100, 2_500
    src = rng.randint(0, n_src, e)
    dst = rng.randint(0, n_dst - 512, e)
    dst[dst >= 1024] += 512
    src = np.concatenate([src, src[:300]])
    dst = np.concatenate([dst, dst[:300]])
    w = rng.rand(len(src)).astype(np.float32)
    return src, dst, w, n_src, n_dst


@pytest.mark.parametrize('group', [8, 4])
@pytest.mark.parametrize('use_native', [True, False],
                         ids=['native-as-is', 'numpy'])
def test_tile_layout_equals_pallas_direction(monkeypatch, group, use_native):
    src, dst, w, n_src, n_dst = _layout_graph()
    monkeypatch.setattr(pallas_spmm, 'GROUP', group)
    if not use_native:
        monkeypatch.setattr(native, 'available', lambda: False)
    op = pallas_spmm.PallasDirection(src, dst, w, n_src, n_dst)
    lay = tile_layout(src, dst, w, n_src, n_dst, group=group)
    assert (lay.n_dst_blocks, lay.n_src_padded, lay.n_groups) == (
        op.n_dst_blocks, op.n_src_padded, op.n_groups)
    np.testing.assert_array_equal(lay.packed, np.asarray(op.packed))
    np.testing.assert_array_equal(lay.w, np.asarray(op.w))
    np.testing.assert_array_equal(lay.chunk_sb, np.asarray(op.chunk_sb))
    np.testing.assert_array_equal(lay.group_ptr, np.asarray(op.group_ptr))
    assert lay.group_ptr[3] == lay.group_ptr[2]     # the empty block
    assert lay.packed.dtype == np.int32 and lay.w.dtype == np.float32


def test_tile_layout_without_edges_equals_native_pallas_direction():
    """No edge at all: one group of zeros, every block empty, as the JAX
    package's native builder lays it out (its numpy path cannot: it
    concatenates no runs)."""
    ensure_jax_native(native)
    src = dst = np.zeros(0, np.int64)
    w = np.zeros(0, np.float32)
    op = pallas_spmm.PallasDirection(src, dst, w, 1_300, 2_100)
    lay = tile_layout(src, dst, w, 1_300, 2_100)
    assert (lay.n_dst_blocks, lay.n_src_padded, lay.n_groups,
            lay.n_slots) == (op.n_dst_blocks, op.n_src_padded, op.n_groups,
                             0)
    for name in ('packed', 'w', 'chunk_sb', 'group_ptr'):
        np.testing.assert_array_equal(getattr(lay, name),
                                      np.asarray(getattr(op, name)))
    assert not lay.group_ptr.any() and not lay.w.any()


def test_tile_layout_at_the_lab_shape():
    """The full lab graph's layout: the counts the chip run works with,
    from the JAX lab's own edge arrays."""
    src, dst, w, _ = tkl.lab_graph()
    np.testing.assert_array_equal(src, jkl.SRC)
    np.testing.assert_array_equal(dst, jkl.DST)
    np.testing.assert_array_equal(w, jkl.W)
    lay = tile_layout(src, dst, w, tkl.NI, tkl.NU)
    assert (lay.n_slots, lay.n_groups, lay.n_dst_blocks,
            lay.n_src_padded) == (845_824, 826, 118, 25_088)
    assert int(np.diff(lay.group_ptr).max()) == 7


def test_block_padded_ids():
    ids = np.sort(np.random.RandomState(4).randint(0, 1_500, 700))
    got = block_padded_ids(ids)
    assert len(got) % 128 == 0 and got.dtype == np.int32
    chunks = got.reshape(-1, 128) // 512
    assert (chunks == chunks[:, :1]).all()     # no chunk straddles blocks
    np.testing.assert_array_equal(np.unique(got), np.unique(ids))
    for b in range(3):
        run = got[got // 512 == b]
        real = ids[ids // 512 == b]
        np.testing.assert_array_equal(run[:len(real)], real)
        assert (run[len(real):] == real[0]).all()


# --- (b) the five L1 modes --------------------------------------------------

@pytest.mark.parametrize('xd,mode,group', L1_CASES,
                         ids=[f'{xd}-{m}-group{g}' for xd, m, g in L1_CASES])
def test_spmm_lab_plain_equals_jax_lab(labs, xd, mode, group):
    layout, port_x, jax_x, jax_dtype, want = labs['l1'][xd, mode, group]
    assert port_x.dtype == DTYPES[xd]
    assert jax_dtype == ('float32' if xd == 'f32' else 'bfloat16')
    # the same draw order and the same rounding to x's dtype
    np.testing.assert_array_equal(port_x.float().numpy(), jax_x)
    got = tkl.spmm_lab_plain(layout.to('cpu'), port_x, mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_spmm_lab_full_is_the_dense_spmm(labs):
    """``full`` (and ``merged_scatter``) is the SpMM of the edges, with
    duplicates summed and zero rows past the destinations."""
    src, dst, w = labs['graph']
    layout, x, *_ = labs['l1']['f32', 'full', 8]
    want = np.zeros((NU, D), np.float64)
    np.add.at(want, dst, x.numpy()[src].astype(np.float64) * w[:, None])
    lay = layout.to('cpu')
    for mode in ('full', 'merged_scatter'):
        got = tkl.spmm_lab_plain(lay, x, mode).numpy()
        np.testing.assert_allclose(got[:NU], want, atol=TOL, rtol=TOL)
        assert not got[NU:].any()


# --- (c), (d) the gathers ---------------------------------------------------

def test_gather_onehot_equals_jax_lab_bitwise(labs):
    ids, x, want = labs['l2']
    ids_p = block_padded_ids(np.sort(ids))
    got = tgl.gather_rows_plain(torch.from_numpy(x), torch.from_numpy(ids_p))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_dma_equals_jax_lab_bitwise(labs):
    ids, x, want = labs['l3']
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgl, 'DMA_ROWS', G_DMA)
        ids_d = tgl.mode_ids(ids, 'dma')
    assert len(ids_d) == 896 == want.shape[0]
    got = tgl.gather_rows_plain(torch.from_numpy(x), torch.from_numpy(ids_d))
    np.testing.assert_array_equal(got.numpy(), want)


# --- (e) the entry points ---------------------------------------------------

@pytest.fixture()
def small_labs(monkeypatch):
    for name, v in (('E', E), ('NI', NI), ('NU', NU), ('D', D)):
        monkeypatch.setattr(tkl, name, v)
    for name, v in (('N_ROWS', G_ROWS), ('N_SRC', G_SRC),
                    ('DMA_ROWS', G_DMA)):
        monkeypatch.setattr(tgl, name, v)
    monkeypatch.delenv('TEXTGCN_TPU_LAB_XDTYPE', raising=False)


def test_kernel_lab_main_on_the_cpu(small_labs, monkeypatch, capsys):
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    got = tkl.main(['full', 'scat_bf16'])
    assert list(got) == ['full', 'scat_bf16']
    src, dst, w, rng = tkl.lab_graph()
    layout = tile_layout(src, dst, w, NI, NU)
    for mode in got:    # one x per mode, bf16 by default
        x = tkl.lab_x(rng, layout.n_src_padded, torch.bfloat16)
        want = tkl.spmm_lab_plain(layout.to('cpu'), x, mode)
        assert got[mode]['checksum'] == pytest.approx(
            float(want.double().sum()), abs=1e-9)
    out = capsys.readouterr().out
    assert 'checksum' in out and 'ms/call' not in out
    monkeypatch.setenv('TEXTGCN_TPU_LAB_XDTYPE', 'f32')
    assert set(tkl.main([])) == set(tkl.DEFAULT_MODES)
    with pytest.raises(SystemExit, match='unknown mode'):
        tkl.main(['nope'])


def test_gather_lab_main_on_the_cpu(small_labs, monkeypatch):
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    got = tgl.main([])
    ids, rng = tgl.lab_ids()
    for mode in tgl.MODES:
        x = tgl.lab_x(rng, tgl.D if mode == 'onehot' else tgl.DMA_D)
        want = x.index_select(0, torch.from_numpy(tgl.mode_ids(ids, mode)))
        assert got[mode]['checksum'] == pytest.approx(
            float(want.double().sum()), abs=1e-9)
    with pytest.raises(SystemExit, match='unknown mode'):
        tgl.main(['onehot', 'nope'])


def test_lab_mains_raise_without_cuda(small_labs, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('this host has a GPU: the labs would run on it')
    monkeypatch.delenv('TEXTGCN_TPU_PLATFORM', raising=False)
    for main in (tkl.main, tgl.main):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            main([])
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'tpu')
    with pytest.raises(ValueError, match='TEXTGCN_TPU_PLATFORM'):
        tkl.main([])


# --- (f) the wrappers -------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors(labs):
    layout, x, *_ = labs['l1']['f32', 'full', 8]
    lay = layout.to('cpu')
    before = (tkl.spmm_lab_cuda.launches, tgl.gather_rows_cuda.launches,
              tgl.gather_rows_bulk_cuda.launches)
    with pytest.raises(ValueError, match='CUDA'):
        tkl.spmm_lab_cuda(lay, x, 'full')
    ids = torch.arange(10, dtype=torch.int32)
    for fn in (tgl.gather_rows_cuda, tgl.gather_rows_bulk_cuda):
        with pytest.raises(ValueError, match='CUDA'):
            fn(torch.zeros(16, 128), ids)
    assert (tkl.spmm_lab_cuda.launches, tgl.gather_rows_cuda.launches,
            tgl.gather_rows_bulk_cuda.launches) == before


def test_wrappers_check_their_arguments(labs):
    layout, x, *_ = labs['l1']['f32', 'full', 8]
    lay = layout.to('cpu')
    with pytest.raises(ValueError, match='mode'):
        tkl.spmm_lab_plain(lay, x, 'sideways')
    with pytest.raises(ValueError, match='x must be'):
        tkl.spmm_lab_plain(lay, x[1:], 'full')
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        tkl.spmm_lab_plain(lay, x.double(), 'full')
    with pytest.raises(ValueError, match='TileLayout.to'):
        tkl.spmm_lab_plain(layout, x, 'full')     # numpy arrays
    with pytest.raises(ValueError, match='int32'):
        tgl.gather_rows_plain(torch.zeros(4, 4), torch.zeros(2))


def test_bounds_count_what_the_mode_moves(labs):
    """No ``no_gather`` read touches more than 128 rows a source block,
    and the bytes count the slots, the rows read and the whole output."""
    layout, x, *_ = labs['l1']['bf16', 'full', 8]
    lay = layout.to('cpu')
    _, by, full_bytes = tkl.spmm_lab_bound(lay, x, 'full')
    _, _, ng_bytes = tkl.spmm_lab_bound(lay, x, 'no_gather')
    n, d = lay.n_slots, x.shape[1]
    fixed = 8 * n + 4 * (n // 128 + lay.n_dst_blocks + 1) + \
        4 * lay.n_dst_blocks * 512 * d
    assert by == 'bytes'
    assert full_bytes - fixed == 2 * d * len(np.unique(
        tkl._slots(lay, 'full')[0].numpy()))
    assert 0 < ng_bytes - fixed <= 2 * d * 128 * 2
    ids = torch.tensor([3, 3, 5], dtype=torch.int32)
    assert tgl.gather_bound(torch.zeros(8, 4), ids)[2] == 4 * 3 + (2 + 3) * 16
