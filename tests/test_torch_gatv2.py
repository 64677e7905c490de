"""The port's GATv2 attention (``ops/gat.py``, K5/K6's plain twins)
against the JAX package's, on the CPU, and the wrappers' pick of the
K4-K6 kernel instances.

K5 and K6 run only on the card, where ``chip_smoke.py`` holds them against
``gatv2_att_plain``/``gatv2_bwd_plain``; here the autograd function takes
the plain versions.  The oracle with dropout is the JAX package's segment
softmax (``conv._attention_direction``) with {0, 1} masks from
``edge_dropout_scale``, since its CPU model would draw Bernoulli masks;
once also its Pallas ``gatv2_direction`` in interpret mode.  Tolerances:
forward rtol 1e-5, gradients atol = rtol = 1e-4, as
``tests/test_pallas_gat.py`` states them (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textgcn_tpu.models.conv import _attention_direction, _leaky
from textgcn_tpu.ops.pallas_spmm import PallasGraphOp
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu_torch.ops import gat
from textgcn_tpu_torch.ops.spmm import GraphOp

SALT = 0x9E3779B9
KEEP = float(np.float32(1.0 - 0.4))
D = 16
NU, NI = 60, 45


def _graph(seed=0, nu=NU, ni=NI, e=260):
    """Unique random edges over the low ids only: users >= 50 and items
    >= 38 are isolated."""
    rng = np.random.RandomState(seed)
    pairs = np.unique(np.stack([rng.randint(0, nu - 10, e),
                                rng.randint(0, ni - 7, e)], 1), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


def _op(eu, ei):
    return GraphOp(eu, ei, np.ones(len(eu), np.float32), NU, NI, 'cpu')


def _mask01(eu, ei, salt, keep):
    return (jax_scale(jnp.asarray(eu), jnp.asarray(ei), jnp.uint32(salt),
                      jnp.float32(keep)) > 0).astype(jnp.float32)


def _tables(rng, n_src, n_dst):
    """hs_src, hs_dst, hd_dst and a, float32."""
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(n_src, D), f(n_dst, D), f(n_dst, D), (0.5 * f(D))


@pytest.mark.parametrize('direction', ['to_user', 'to_item'])
@pytest.mark.parametrize('keep', [1.0, KEEP, float(np.float32(0.15))])
def test_gatv2_direction_matches_segment_softmax(direction, keep):
    """Forward and gradients in hs (both sides), hd and a, with rows whose
    edges are all dropped and isolated rows."""
    eu, ei = _graph()
    op = _op(eu, ei)
    if direction == 'to_user':
        src, dst, n_src, n_dst = ei, eu, NI, NU
    else:
        src, dst, n_src, n_dst = eu, ei, NU, NI
    rng = np.random.RandomState(1)
    args = _tables(rng, n_src, n_dst)
    mask = _mask01(eu, ei, SALT, keep)
    cot = rng.randn(n_dst, D).astype(np.float32)
    if keep < 0.5:   # some destinations with edges keep none of them
        kept = np.bincount(dst, weights=np.asarray(mask), minlength=n_dst)
        assert ((np.bincount(dst, minlength=n_dst) > 0) & (kept == 0)).any()

    def jax_out(hs_src, hs_dst, hd_dst, a):
        return _attention_direction(
            hs_src, _leaky(hs_src[src] + hd_dst[dst]) @ a,
            _leaky(hs_dst + hd_dst) @ a, hs_dst, src, dst, mask, n_dst)

    want, vjp = jax.vjp(jax_out, *map(jnp.asarray, args))
    want_g = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = gat.gatv2_direction(op, direction, *targs, SALT, keep)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for name, t, w in zip(('hs_src', 'hs_dst', 'hd_dst', 'a'), targs,
                          want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    assert gat.gatv2_fwd_cuda.launches == gat.gatv2_bwd_cuda.launches == 0


def test_gatv2_direction_matches_jax_pallas_interpret(monkeypatch):
    """Once against the JAX package's own kernel path: a tiny
    single-split ``PallasGraphOp`` run in interpret mode in f32; the
    gradients in hs_src, hd_dst and a go through its K6."""
    from textgcn_tpu.ops.pallas_gat import gatv2_direction as jax_gatv2
    monkeypatch.setenv('TEXTGCN_TPU_PALLAS_XDTYPE', 'f32')
    pad = 512
    eu, ei = _graph(3)
    ones = np.ones(len(eu), np.float32)
    jop = PallasGraphOp(eu, ei, ones, pad, pad, D, interpret=True)
    assert len(jop.l_i2u.splits) == 1
    rng = np.random.RandomState(4)
    hs_i, hs_u, hd_u, a = _tables(rng, NI, NU)

    def padded(x):
        out = np.zeros((pad,) + x.shape[1:], np.float32)
        out[:len(x)] = x
        return jnp.asarray(out)

    cot = rng.randn(NU, D).astype(np.float32)

    def loss(hs, hd, av):
        out = jax_gatv2(jop, 'to_user', hs, padded(hs_u), hd, av,
                        jnp.uint32(SALT), jnp.float32(KEEP), interpret=True)
        return (out[:NU] * cot).sum(), out[:NU]

    (_, want), g_want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        padded(hs_i), padded(hd_u), jnp.asarray(a))
    targs = [torch.from_numpy(x).requires_grad_() for x in (hs_i, hd_u, a)]
    got = gat.gatv2_direction(_op(eu, ei), 'to_user', targs[0],
                              torch.from_numpy(hs_u), targs[1], targs[2],
                              SALT, KEEP)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for name, t, w, n in zip(('hs_src', 'hd_dst', 'a'), targs, g_want,
                             (NI, NU, D)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w)[:n],
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_plain_outputs_at_the_sentinel():
    """A destination without a kept edge: num = 0, den = 0, m = NEG, and
    its backward contributions (dhd) are exact zeros."""
    eu, ei = _graph(2)
    op = _op(eu, ei)
    rng = np.random.RandomState(0)
    hs_i, _, hd_u, a = map(torch.from_numpy, _tables(rng, NI, NU))
    keep = float(np.float32(0.05))
    num, den, m = gat.gatv2_att_plain(op.l_i2u, hs_i, hd_u, a, SALT, keep)
    empty = m == gat.NEG
    assert empty.sum() > 10 and (~empty).any()
    assert (num[empty] == 0).all() and (den[empty] == 0).all()
    assert (den[~empty] >= 1.0 - 1e-6).all()      # the max edge has e = 1
    g_num = torch.randn(NU, D, generator=torch.Generator().manual_seed(1))
    g_den = torch.randn(NU, generator=torch.Generator().manual_seed(2))
    dhs, dhd, da = gat.gatv2_bwd_plain(op.l_u2i, hs_i, hd_u, a, m, g_num,
                                       g_den, SALT, keep)
    assert (dhd[empty] == 0).all()
    assert dhs.shape == hs_i.shape and dhd.shape == hd_u.shape
    assert da.shape == a.shape
    assert all(torch.isfinite(t).all() for t in (dhs, dhd, da))


@pytest.mark.parametrize('aligned16', [True, False])
def test_k6_layout_covers_every_even_width(aligned16):
    """The pick of K4's, K5's and K6's instance (``att_layout``, one rule
    for the three): float4 only for ``d % 4 == 0`` and 16-byte aligned
    tables, and the fewest vectors a lane (1, 2, 4, or 8 for float2) whose
    16 lanes cover ``d``, for every even d the wrappers take; every pick is
    one of the seven instances each source builds."""
    instances = {(2, 1), (2, 2), (2, 4), (2, 8), (4, 1), (4, 2), (4, 4)}
    for d in range(2, gat.MAX_D + 1, 2):
        vec, per = gat.att_layout(d, aligned16)
        assert vec == (4 if d % 4 == 0 and aligned16 else 2), d
        assert per in ((1, 2, 4) if vec == 4 else (1, 2, 4, 8)), d
        assert 16 * vec * per >= d, d
        assert per == 1 or 16 * vec * (per // 2) < d, d
        assert (vec, per) in instances, d
    assert gat.att_layout(64, True) == (4, 1)   # S1: one float4 a lane
    assert gat.att_layout(62, True) == (2, 2)


def table_views(shapes, misaligned: bool, seed: int = 0):
    """Float32 tensors of ``shapes`` cut from one buffer: the first on the
    16-byte grid, each other one on it too or, when ``misaligned``, 8
    bytes past it."""
    gen = torch.Generator().manual_seed(seed)
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes) + 6 * len(shapes), generator=gen)
    out, at = [], 0
    for shape, n in zip(shapes, sizes):
        out.append(flat[at:at + n].view(shape))
        at = -(-(at + n) // 4) * 4 + (2 if misaligned else 0)
    assert flat.data_ptr() % 16 == 0
    return out


def capture_launches(monkeypatch) -> list:
    """Let the kernel wrappers run on CPU tensors up to their launch, and
    record each launch's kernel name and (vec, per) instead."""
    seen = []
    monkeypatch.setattr(gat, '_check_cuda', lambda name, d, tensors: None)
    monkeypatch.setattr(gat, '_kernel_fn', lambda *a, **k: None)
    monkeypatch.setattr(gat, '_launch', lambda name, fn, ptrs, *a,
                        layout=(), **k: seen.append((name, layout)))
    return seen


@pytest.mark.parametrize('kernel', ['gat_bwd', 'gatv2_fwd', 'gatv2_bwd'])
@pytest.mark.parametrize('misaligned', [False, True])
def test_attention_wrappers_pick_their_instance_for_every_even_width(
        monkeypatch, kernel, misaligned):
    """K4's, K5's and K6's wrappers hand the kernel ``att_layout``'s pick
    for every even d: float4 only when d % 4 == 0 and all of the tables
    it reads in vectors lie on the 16-byte grid (K4: h, g_num and dh; K5:
    hs, hd, a and num; K6: hs, hd, a, g_num, dhs and dhd)."""
    seen = capture_launches(monkeypatch)
    op = _op(*_graph())
    for d in range(2, gat.MAX_D + 1, 2):
        hs, hd, a, g_num = table_views([(NI, d), (NU, d), (d,), (NU, d)],
                                       misaligned, seed=d)
        if kernel == 'gat_bwd':
            got = gat.gat_bwd_cuda(op.l_u2i, hs, torch.zeros(NI),
                                   torch.zeros(NU), torch.zeros(NU), g_num,
                                   torch.zeros(NU), SALT, KEEP)
            want = [(NI, d), (NI,), (NU,)]
        elif kernel == 'gatv2_fwd':
            got = gat.gatv2_fwd_cuda(op.l_i2u, hs, hd, a, SALT, KEEP)
            want = [(NU, d), (NU,), (NU,)]
        else:
            got = gat.gatv2_bwd_cuda(op.l_u2i, hs, hd, a, torch.zeros(NU),
                                     g_num, torch.zeros(NU), SALT, KEEP)
            want = [(NI, d), (NU, d), (d,)]
        assert [tuple(t.shape) for t in got] == want, d
        aligned = d % 4 == 0 and not misaligned
        assert seen.pop() == (kernel, gat.att_layout(d, aligned)), d
    assert not seen
    gat.gat_bwd_cuda.launches = 0
    gat.gatv2_fwd_cuda.launches = gat.gatv2_bwd_cuda.launches = 0


def test_gatv2_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches K5/K6: the wrappers raise, and a bad
    shape is refused before anything runs."""
    op = _op(*_graph())
    hs_i, hd_u, a = torch.randn(NI, D), torch.randn(NU, D), torch.randn(D)
    with pytest.raises(ValueError, match='CUDA'):
        gat.gatv2_fwd_cuda(op.l_i2u, hs_i, hd_u, a, 0, 1.0)
    with pytest.raises(ValueError, match='CUDA'):
        gat.gatv2_bwd_cuda(op.l_u2i, hs_i, hd_u, a, torch.randn(NU),
                           torch.randn(NU, D), torch.randn(NU), 0, 1.0)
    with pytest.raises(ValueError, match='hd_dst'):
        gat.gatv2_att_plain(op.l_i2u, hs_i, hd_u[:-1], a, 0, 1.0)
    with pytest.raises(ValueError, match='a must be'):
        gat.gatv2_bwd_plain(op.l_u2i, hs_i, hd_u, a[:-1], torch.randn(NU),
                            torch.randn(NU, D), torch.randn(NU), 0, 1.0)
    assert gat.gatv2_fwd_cuda.launches == gat.gatv2_bwd_cuda.launches == 0
