"""The port's SpMM (K1's plain version and its wrapper) against the JAX
package's Pallas SpMM in interpret mode, in exact float32.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``spmm_plain`` there); on the CPU the wrapper takes the plain
version, and the kernel's launch counter must stay at 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textgcn_tpu.ops.pallas_spmm import SRC_BLOCK, PallasGraphOp
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu.ops.pallas_spmm import hash_dropout_salts as jax_salts
from textgcn_tpu_torch import cuda_build
from textgcn_tpu_torch.ops import spmm as tspmm

SALTS = [0, 1, 7, 2**31, 0x9E3779B9, 2**32 - 1]
N_USERS, N_ITEMS, N_EDGES, D = 1300, 700, 3000, 16
ATOL = 1e-5   # f32 sums of <= ~10 terms in another order


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
