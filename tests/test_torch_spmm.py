"""The port's SpMM (K1's plain version and its wrapper) against the JAX
package's Pallas SpMM in interpret mode, in exact float32.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``spmm_plain`` there); on the CPU the wrapper takes the plain
version, and the kernel's launch counter must stay at 0.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_native import ensure_jax_native
from textgcn_tpu import native
from textgcn_tpu.ops.pallas_spmm import SRC_BLOCK, PallasGraphOp
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu.ops.pallas_spmm import hash_dropout_salts as jax_salts
from textgcn_tpu_torch import cuda_build
from textgcn_tpu_torch.ops import spmm as tspmm

SALTS = [0, 1, 7, 2**31, 0x9E3779B9, 2**32 - 1]
N_USERS, N_ITEMS, N_EDGES, D = 1300, 700, 3000, 16
ATOL = 1e-5   # f32 sums of <= ~10 terms in another order


@pytest.fixture(scope='module', autouse=True)
def _jax_native():
    """The JAX oracle lays out its tiles through its native builder
    (``tests/helpers/torch_native.py``), never the numpy fallback."""
    ensure_jax_native(native)


@pytest.mark.parametrize('salt', SALTS)
@pytest.mark.parametrize('keep', [0.6, 1.0, 0.25])
def test_hash_mask_bit_equal_to_jax(salt, keep):
    rng = np.random.RandomState(salt % 1000)
    users = rng.randint(0, 2**20, 50_000).astype(np.int32)
    items = rng.randint(0, 2**20, 50_000).astype(np.int32)
    want = np.asarray(jax_scale(jnp.asarray(users), jnp.asarray(items),
                                jnp.uint32(salt), jnp.float32(keep)))
    got = tspmm.edge_dropout_scale(torch.from_numpy(users),
                                   torch.from_numpy(items), salt,
                                   float(np.float32(keep))).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_salts_keep_is_float32_of_one_minus_p():
    import jax
    (_, keep_j), _ = jax_salts(jax.random.key(0), 0.4)
    gen = torch.Generator().manual_seed(0)
    (s0, keep_t), (s1, keep_t2) = tspmm.hash_dropout_salts(gen, 0.4)
    assert keep_t == keep_t2 == float(keep_j)
    assert 0 <= s0 < 2**32 and 0 <= s1 < 2**32 and s0 != s1
    assert tspmm.hash_dropout_salts(gen, 0.0) == ((0, 1.0), (0, 1.0))
    assert tspmm.hash_dropout_salts(None, 0.4) == ((0, 1.0), (0, 1.0))


@pytest.fixture(scope='module')
def graph():
    rng = np.random.RandomState(0)
    eu = rng.randint(0, N_USERS, N_EDGES).astype(np.int32)
    ei = rng.randint(0, N_ITEMS, N_EDGES).astype(np.int32)
    w = rng.rand(N_EDGES).astype(np.float32)
    nu_t = -(-N_USERS // SRC_BLOCK) * SRC_BLOCK
    ni_t = -(-N_ITEMS // SRC_BLOCK) * SRC_BLOCK
    jax_op = PallasGraphOp(eu, ei, w, nu_t, ni_t, D, interpret=True,
                           x_dtype=jnp.float32)
    port_op = tspmm.GraphOp(eu, ei, w, N_USERS, N_ITEMS, 'cpu')
    return eu, ei, w, jax_op, port_op, (nu_t, ni_t)


@pytest.mark.parametrize('direction', ['to_user', 'to_item'])
@pytest.mark.parametrize('keep', [1.0, 0.6])
def test_graph_op_matches_jax_pallas(graph, direction, keep):
    eu, ei, w, jax_op, port_op, (nu_t, ni_t) = graph
    rng = np.random.RandomState(1)
    n_src, n_src_t = ((N_ITEMS, ni_t) if direction == 'to_user'
                      else (N_USERS, nu_t))
    x = rng.randn(n_src, D).astype(np.float32)
    x_pad = np.zeros((n_src_t, D), np.float32)
    x_pad[:n_src] = x
    salt = 0x9E3779B9
    keep32 = float(np.float32(keep))
    want = np.asarray(getattr(jax_op, direction)(
        jnp.asarray(x_pad), (jnp.uint32(salt), jnp.float32(keep))))
    got = getattr(port_op, direction)(torch.from_numpy(x), (salt, keep32))
    n_dst = N_USERS if direction == 'to_user' else N_ITEMS
    np.testing.assert_allclose(got.numpy(), want[:n_dst], atol=ATOL, rtol=0)
    csr = port_op.l_i2u if direction == 'to_user' else port_op.l_u2i
    plain = tspmm.spmm_plain(csr, torch.from_numpy(x), salt, keep32)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_plain_matches_dense_oracle(graph):
    """Independent of JAX: a dense numpy product with the mask applied."""
    eu, ei, w, _, port_op, _ = graph
    rng = np.random.RandomState(2)
    x = rng.randn(N_ITEMS, D).astype(np.float32)
    salt, keep = 2**31 + 5, float(np.float32(0.6))
    scale = tspmm.edge_dropout_scale(torch.from_numpy(eu),
                                     torch.from_numpy(ei), salt,
                                     keep).numpy()
    want = np.zeros((N_USERS, D), np.float64)
    np.add.at(want, eu, x[ei].astype(np.float64)
              * (w * scale)[:, None].astype(np.float64))
    got = port_op.to_user(torch.from_numpy(x), (salt, keep))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert 0.55 < (scale > 0).mean() < 0.65


def test_csr_is_dst_sorted_and_complete(graph):
    eu, ei, w, _, port_op, _ = graph
    csr = port_op.l_u2i
    assert csr.rowptr.dtype == csr.col.dtype == torch.int32
    assert csr.n_dst == N_ITEMS and csr.n_src == N_USERS
    assert not csr.dst_is_user and port_op.l_i2u.dst_is_user
    rowptr = csr.rowptr.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == N_EDGES
    assert (np.diff(rowptr) >= 0).all()
    rows = np.repeat(np.arange(N_ITEMS), np.diff(rowptr))
    got = sorted(zip(rows.tolist(), csr.col.numpy().tolist(),
                     csr.w.numpy().tolist()))
    want = sorted(zip(ei.tolist(), eu.tolist(), w.tolist()))
    assert got == want


def test_cpu_path_never_launches_the_kernel(graph):
    *_, port_op, _ = graph
    before = tspmm.spmm_dropout_cuda.launches
    x = torch.randn(N_ITEMS, D)
    port_op.to_user(x, (3, 0.5))
    port_op.to_item(torch.randn(N_USERS, D), (3, 0.5))
    assert tspmm.spmm_dropout_cuda.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensors(graph):
    """No fallback: the wrapper launches the kernel or raises."""
    *_, port_op, _ = graph
    with pytest.raises(ValueError, match='CUDA'):
        tspmm.spmm_dropout_cuda(port_op.l_i2u, torch.randn(N_ITEMS, D),
                                0, 1.0)
    assert tspmm.spmm_dropout_cuda.launches == 0


@pytest.mark.parametrize('aligned16', [True, False])
def test_k1_layout_covers_every_even_width(aligned16):
    """The wrapper's pick of K1's instance: float4 only for ``d % 4 == 0``
    and a 16-byte aligned ``x``, and the fewest lanes (8, 16, 32) whose
    ``lanes * vec`` columns cover ``d``, 32 for a wider ``d``."""
    for d in range(2, 513, 2):
        vec, lanes = tspmm.k1_layout(d, aligned16)
        assert vec == (4 if d % 4 == 0 and aligned16 else 2), d
        assert lanes in (8, 16, 32), d
        assert lanes == 32 or lanes * vec >= d, d
        assert lanes == 8 or lanes // 2 * vec < d, d
    assert tspmm.k1_layout(64, True) == (4, 16)   # S1: a half-warp a row
    assert tspmm.k1_layout(64, False) == (2, 32)


@pytest.mark.parametrize('misaligned', [False, True])
def test_k2_wrapper_picks_its_instance_for_every_even_width(
        monkeypatch, graph, misaligned):
    """K2's wrapper hands the kernel K1's layout rule, ``k1_layout``, for
    every even d: float4 only when d % 4 == 0 and ``x`` (and the ``out`` it
    allocates) lie on the 16-byte grid.  The launch is intercepted, so the
    wrapper runs on CPU tensors up to it."""
    *_, port_op, _ = graph
    csr = port_op.l_i2u
    seen = []

    def launch(*args):
        seen.append(args[7:9])   # (vec, lanes) after the pointers, n, d
        return 0

    monkeypatch.setattr(tspmm, '_check_cuda', lambda name, x: None)
    monkeypatch.setattr(tspmm, '_weighted_fn', lambda: launch)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    for d in range(2, 513, 2):
        flat = torch.randn(N_ITEMS * d + 2)
        assert flat.data_ptr() % 16 == 0
        x = flat[2:].view(N_ITEMS, d) if misaligned else \
            flat[:-2].view(N_ITEMS, d)
        out = tspmm.spmm_weighted_cuda(csr, csr.w, x)
        assert out.shape == (N_USERS, d) and out.data_ptr() % 16 == 0, d
        aligned = d % 4 == 0 and not misaligned
        assert seen.pop() == tspmm.k1_layout(d, aligned), d
    assert not seen
    tspmm.spmm_weighted_cuda.launches = 0


@pytest.mark.parametrize('bad, err', [
    (dict(x=torch.randn(N_ITEMS + 1, D)), ValueError),
    (dict(x=torch.randn(N_ITEMS, D, dtype=torch.float64)), TypeError),
    (dict(keep=0.0), ValueError),
    (dict(keep=1.5), ValueError),
    (dict(salt=2**32), ValueError),
    (dict(x=torch.randn(N_ITEMS, D, device='meta')), ValueError),
])
def test_spmm_checks_its_arguments(graph, bad, err):
    *_, port_op, _ = graph
    args = dict(x=torch.randn(N_ITEMS, D), salt=0, keep=1.0)
    args.update(bad)
    with pytest.raises(err):
        tspmm.spmm(port_op.l_i2u, args['x'], args['salt'], args['keep'])


def test_graph_op_refuses_gradients(graph):
    """First-order gradients flow (K1 on the transpose CSR, here its
    plain version); a second-order gradient is refused."""
    *_, port_op, _ = graph
    x = torch.randn(N_ITEMS, D, requires_grad=True)
    out = port_op.to_user(x, (SALTS[4], 0.6))
    g = torch.randn(N_USERS, D)
    (dx,) = torch.autograd.grad(out, x, g, create_graph=True)
    want = tspmm.spmm_plain(port_op.l_u2i, g, SALTS[4], 0.6)
    np.testing.assert_allclose(dx.detach().numpy(), want.numpy(), atol=ATOL)
    with pytest.raises(RuntimeError, match='twice|once_differentiable|grad'):
        dx.sum().backward()
    with torch.no_grad():
        assert port_op.to_user(x, (0, 1.0)).shape == (N_USERS, D)


def test_build_helper_names_sources_and_targets():
    assert cuda_build.sources() == ['gat_bwd.cu', 'gat_fwd.cu',
                                    'gather_lab.cu', 'gatv2_bwd.cu',
                                    'gatv2_fwd.cu', 'spmm_dropout.cu',
                                    'spmm_lab.cu', 'spmm_weighted.cu']
    path = cuda_build.library_path('spmm_dropout.cu')
    assert path.startswith(cuda_build.BUILD_DIR) and path.endswith('.so')
    assert path == cuda_build.library_path('spmm_dropout.cu')
    assert 'arch=compute_90a,code=sm_90a' in cuda_build.NVCC_FLAGS
    assert not any('fast_math' in f for f in cuda_build.NVCC_FLAGS)


def _long_rowptr(seed: int) -> np.ndarray:
    """A rowptr whose lengths mix empty, short, exactly-``SPLIT_LEN`` and
    long rows, some of equal length."""
    rng = np.random.RandomState(seed)
    L = tspmm.SPLIT_LEN
    length = np.concatenate([
        rng.randint(0, L + 1, 200), [0, L, L + 1, 2 * L, 2 * L + 1, 5 * L,
                                     3 * L + 7, 3 * L + 7],
        rng.randint(L + 1, 12 * L, 30)])
    rng.shuffle(length)
    return np.concatenate([[0], np.cumsum(length)])


@pytest.mark.parametrize('split_len', [1, 3, 64, tspmm.SPLIT_LEN])
@pytest.mark.parametrize('seed', [0, 1])
def test_split_schedule_covers_long_rows_in_chunks(split_len, seed):
    """Each row longer than ``split_len`` edges: its edges exactly once,
    in CSR order, in chunks of at most ``split_len``, the heaviest rows
    first (ties in row order); shorter rows have no chunks."""
    rowptr = _long_rowptr(seed)
    length = np.diff(rowptr)
    work, first = tspmm.split_schedule(rowptr, split_len)
    assert work.dtype == first.dtype == np.int32 and work.shape[1] == 4
    long_rows = np.flatnonzero(length > split_len)
    assert first[0] == 0 and first[-1] == len(work)
    assert len(first) == len(long_rows) + 1
    rows = []
    for j in range(len(first) - 1):
        chunk = work[first[j]:first[j + 1]]
        row = int(chunk[0, 0])
        rows.append(row)
        assert (chunk[:, 0] == row).all() and (chunk[:, 3] == j).all()
        assert chunk[0, 1] == rowptr[row] and chunk[-1, 2] == rowptr[row + 1]
        assert (chunk[1:, 1] == chunk[:-1, 2]).all()   # consecutive
        size = chunk[:, 2] - chunk[:, 1]
        assert (size > 0).all() and (size <= split_len).all()
        assert (size[:-1] == split_len).all()
    assert sorted(rows) == long_rows.tolist()
    assert rows == sorted(rows, key=lambda r: (-length[r], r))
    covered = np.zeros(rowptr[-1], np.int64)
    for _, b, e, _ in work:
        covered[b:e] += 1
    in_long = np.repeat(length > split_len, length)
    assert (covered == in_long).all()


def test_split_schedule_of_short_rows_is_empty():
    work, first = tspmm.split_schedule(np.arange(0, 4 * 257, 4))
    assert work.shape == (0, 4) and first.tolist() == [0]
    work, _ = tspmm.split_schedule([0, tspmm.SPLIT_LEN])
    assert work.shape == (0, 4)


def _skewed_graph():
    """A small Chung-Lu draw of the benchmark's generator: rows of up to
    ~900 edges each way."""
    from portbench import graphgen
    inter = graphgen.generate(dict(
        n_users=3000, n_items=4000, n_interactions=150_000,
        popularity_exponent=0.5, train_share=0.8, graph_seed=0))
    w = np.random.RandomState(0).rand(len(inter.train_user))
    return (inter.train_user, inter.train_item, w.astype(np.float32),
            inter.n_users, inter.n_items)


def test_split_schedule_empty_on_s1_and_the_tests_graphs(graph):
    """S1 (rows of at most 47 edges) and the tests' graphs get no
    schedule: K1 walks every row as before."""
    from tools.scale_bench import synth_edges
    eu, ei, w = synth_edges(60000, 25000, 10, 0)
    s1 = tspmm.GraphOp(eu, ei, w, 60000, 25000, 'cpu')
    *_, port_op, _ = graph
    for op in (s1, port_op):
        for csr in (op.l_i2u, op.l_u2i):
            assert csr.split is None
            assert (csr.split_rows, csr.chunks, csr.split_edge_share) == (
                0, 0, 0.0)


def test_split_schedule_on_a_skewed_graph():
    eu, ei, w, nu, ni = _skewed_graph()
    op = tspmm.GraphOp(eu, ei, w, nu, ni, 'cpu')
    for csr, dst in ((op.l_i2u, eu), (op.l_u2i, ei)):
        length = np.bincount(dst, minlength=csr.n_dst)
        long_rows = length > tspmm.SPLIT_LEN
        sp = csr.split
        assert sp is not None and sp.split_len == tspmm.SPLIT_LEN
        assert csr.split_rows == long_rows.sum() > 0
        assert csr.chunks == sum(-(-length[long_rows] // tspmm.SPLIT_LEN))
        assert csr.split_edge_share == pytest.approx(
            length[long_rows].sum() / len(dst))
        work, first = tspmm.split_schedule(csr.rowptr.numpy())
        assert np.array_equal(sp.work.numpy(), work)
        assert np.array_equal(sp.first.numpy(), first)
        assert sp.arrivals.dtype == torch.int32
        assert not sp.arrivals.any() and sp.partials == {}


def test_k1_wrapper_passes_the_schedule(monkeypatch, graph):
    """K1's wrapper hands the kernel a skewed CSR's schedule (its tensors,
    chunk count and split length, and a (chunks, d) partials buffer made
    once per width) and nothing for a CSR without one; ``split_launches``
    counts only the former.  The launch is intercepted, so the wrapper
    runs on CPU tensors up to it."""
    seen = []

    def launch(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(tspmm, '_check_cuda', lambda name, x: None)
    monkeypatch.setattr(tspmm, '_kernel_fn', lambda: launch)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    eu, ei, w, nu, ni = _skewed_graph()
    skewed = tspmm.GraphOp(eu, ei, w, nu, ni, 'cpu').l_i2u
    plain = graph[4].l_i2u
    try:
        for d in (64, 64, 32):
            tspmm.spmm_dropout_cuda(skewed, torch.randn(ni, d), 5, 0.6)
            work, first, arrivals, partials = seen[-1][5:9]
            sp = skewed.split
            assert (work, first, arrivals) == (
                sp.work.data_ptr(), sp.first.data_ptr(),
                sp.arrivals.data_ptr())
            assert partials == sp.partials[d].data_ptr()
            assert sp.partials[d].shape == (skewed.chunks, d)
            assert seen[-1][9:13] == (nu, skewed.chunks, tspmm.SPLIT_LEN, d)
        assert sorted(sp.partials) == [32, 64]
        tspmm.spmm_dropout_cuda(plain, torch.randn(N_ITEMS, D), 5, 0.6)
        assert seen[-1][5:9] == (None,) * 4
        assert seen[-1][9:13] == (N_USERS, 0, 0, D)
        assert tspmm.spmm_dropout_cuda.launches == 4
        assert tspmm.spmm_dropout_cuda.split_launches == 3
    finally:
        tspmm.spmm_dropout_cuda.launches = 0
        tspmm.spmm_dropout_cuda.split_launches = 0


@pytest.mark.parametrize('direction', ['to_user', 'to_item'])
def test_plain_path_on_a_skewed_graph_matches_dense_oracle(direction):
    """The CPU path ignores the schedule: a skewed graph's long rows sum
    every kept edge, against a float64 numpy product."""
    eu, ei, w, nu, ni = _skewed_graph()
    op = tspmm.GraphOp(eu, ei, w, nu, ni, 'cpu')
    dst, src, n_dst, n_src = ((eu, ei, nu, ni) if direction == 'to_user'
                              else (ei, eu, ni, nu))
    x = np.random.RandomState(3).randn(n_src, D).astype(np.float32)
    salt, keep = SALTS[4], float(np.float32(0.6))
    scale = tspmm.edge_dropout_scale(torch.from_numpy(eu),
                                     torch.from_numpy(ei), salt,
                                     keep).numpy()
    want = np.zeros((n_dst, D), np.float64)
    np.add.at(want, dst, x[src].astype(np.float64)
              * (w * scale)[:, None].astype(np.float64))
    got = getattr(op, direction)(torch.from_numpy(x), (salt, keep))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
