"""The work of a ``gat`` training step, counted from shapes alone by
``work.py``'s rule (every input read once, every output written once, the
operations the algorithm needs, the expected kept edges at the configured
keep), and the least time of one launch of K3 and of K4.

A step over ``L`` layers, each in both directions, of width ``d``, with
``N`` = users + items rows:

* forward, a layer: ``h = x W`` with the logits ``s = h a_src`` and ``d =
  h a_dst`` (``dense``); K3 in each direction (``k3``); the self-loop fold
  with ``b`` and the layer sum (``fold``);
* backward, a layer: the fold's gradient (``fold_backward``); K4 in each
  direction over the transpose CSR (``k4``); the dense gradients ``dx``,
  ``dW`` and the two attention vectors' (``dense_backward``);
* the batch's rows of the propagated and the layer-0 tables, gathered and
  scattered back, as ``work.lgcn_step`` counts them; Adam over the tables
  and every conv parameter.
"""

from __future__ import annotations

from .work import F32, I32, Shape, Work, gathers

K3_KERNEL = 'gat_fwd_kernel'
K4_KERNEL = 'gat_bwd_kernel'


def k3(n_src: int, n_dst: int, n_edges: int, d: int, keep: float) -> Work:
    """One K3 launch over a forward CSR of ``n_dst`` rows: ``h_src``
    (n_src, d), ``s_src``, ``d_dst`` and the CSR (rowptr, col) read;
    ``num`` (n_dst, d), ``den`` and ``m`` written; ``2d + 6`` operations a
    kept edge (the logit's add and slope, the running max, the exp and its
    argument, ``den``, and ``num``'s multiply-add)."""
    nbytes = F32 * (n_src * d + n_src + n_dst + n_dst * d + 2 * n_dst) \
        + I32 * (n_dst + 1 + n_edges)
    return Work((2 * d + 6) * keep * n_edges, nbytes)


def k4(n_src: int, n_dst: int, n_edges: int, d: int, keep: float) -> Work:
    """One K4 launch over the transpose of a forward CSR from ``n_src``
    sources to ``n_dst`` destinations (its rows are the sources): ``h_src``
    (n_src, d), ``g_num`` (n_dst, d), ``s_src``, ``d_dst``, ``m``,
    ``g_den`` and the transpose CSR read; ``dh`` (n_src, d), ``ds`` and
    ``dd`` written; ``4d + 8`` operations a kept edge (the dot ``g_num .
    h``, ``dh``'s multiply-add, the logit, the exp, ``dz`` and its two
    sums)."""
    nbytes = F32 * (2 * n_src * d + n_dst * d + 2 * n_src + 4 * n_dst) \
        + I32 * (n_src + 1 + n_edges)
    return Work((4 * d + 8) * keep * n_edges, nbytes)


def dense(n: int, d: int) -> Work:
    """``h = x W`` and ``h [a_src a_dst]`` over ``n`` rows: x, W and the
    vectors read, h and the two logits written."""
    return Work(2.0 * n * d * (d + 2),
                F32 * (n * d + d * (d + 2) + n * (d + 2)))


def dense_backward(n: int, d: int) -> Work:
    """The gradients of ``dense``: ``g_h + g_s a_src + g_d a_dst`` into
    ``dx`` (through W) and ``dW`` (against x), and the two vectors' (against
    h): g_h, x, h, g_s, g_d, W and the vectors read; dx, dW and the vectors'
    gradients written."""
    return Work(4.0 * n * d * d + 8.0 * n * d,
                F32 * (4 * n * d + 2 * n + 2 * d * d + 4 * d))


def fold(n: int, d: int) -> Work:
    """The self-loop fold of ``n`` destination rows with ``b`` and the
    layer sum: num, the own rows' h, the running sum, den, the edge max and
    the two logits read; the layer's rows and the sum written."""
    return Work(6.0 * n * d, F32 * (5 * n * d + 4 * n + d))


def fold_backward(n: int, d: int) -> Work:
    """The fold's gradient: the rows' gradient, num, the own rows' h, den,
    the edge max and the loop's logit read; the gradients of num, h, den,
    the loop's logit and b written."""
    return Work(6.0 * n * d, F32 * (5 * n * d + 5 * n + d))


def conv_params(s: Shape) -> int:
    """The conv layers' parameters: W (d, d), a_src, a_dst, b a layer."""
    return s.n_layers * (s.d * s.d + 3 * s.d)


def step(s: Shape, batch: int, neg: int) -> Work:
    """One BPR step of ``gat`` (see the module docstring)."""
    n, d, e = s.n_users + s.n_items, s.d, s.n_edges
    forward = (dense(n, d) + k3(s.n_items, s.n_users, e, d, s.keep)
               + k3(s.n_users, s.n_items, e, d, s.keep) + fold(n, d))
    backward = (fold_backward(n, d) + k4(s.n_items, s.n_users, e, d, s.keep)
                + k4(s.n_users, s.n_items, e, d, s.keep)
                + dense_backward(n, d))
    adam = Work(0.0, 7 * F32 * (n * d + conv_params(s)))
    return (s.n_layers * (forward + backward)
            + 2 * gathers(batch * (2 + neg), d) + adam)


def k3_bound_ms(s: Shape, keep: float) -> float:
    """K3's least time a launch, in ms, averaged over the two directions:
    a step launches as many into the users as into the items."""
    return 0.5e3 * (k3(s.n_items, s.n_users, s.n_edges, s.d, keep).least_s()
                    + k3(s.n_users, s.n_items, s.n_edges, s.d,
                         keep).least_s())


def k4_bound_ms(s: Shape, keep: float) -> float:
    """K4's least time a launch, in ms, averaged over the two directions."""
    return 0.5e3 * (k4(s.n_items, s.n_users, s.n_edges, s.d, keep).least_s()
                    + k4(s.n_users, s.n_items, s.n_edges, s.d,
                         keep).least_s())
