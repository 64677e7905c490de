"""The work of a step or a request, counted from shapes alone, and the
published peaks it is set against.

Whatever implements the work, the count is the same: every input read
once, every output written once, and the floating-point operations the
algorithm needs (2 * d a kept edge of a propagation, 2 * d a score of a
product).  Where the work depends on the data (the edges the hash
dropout keeps), the expected count at the configured keep is used.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 3.35 TB/s
of HBM3 and 67 TFLOP/s in float32 outside the tensor cores.  The port's
catalogue products run in float32 with TF32 off, and its SpMM on the
CUDA cores, so float32 is the peak.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
F32 = 4
I32 = 4
I64 = 8


@dataclass(frozen=True)
class Shape:
    """What the counts depend on: table rows, train edges, width, the
    layers and the keep share of the training dropout."""
    n_users: int
    n_items: int
    n_edges: int
    d: int
    n_layers: int
    keep: float


@dataclass
class Work:
    flops: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: 'Work') -> 'Work':
        return Work(self.flops + other.flops, self.nbytes + other.nbytes)

    def __mul__(self, k: float) -> 'Work':
        return Work(self.flops * k, self.nbytes * k)

    __rmul__ = __mul__

    def least_s(self) -> float:
        """The least time the chip could take: the larger of the
        operations over the f32 peak and the bytes over the HBM peak."""
        return max(self.flops / PEAK_F32_FLOP_PER_S,
                   self.nbytes / PEAK_BYTES_PER_S)


def bound_ms(n_src: int, n_dst: int, n_edges: int, d: int,
             n_kept: float | None = None) -> tuple[float, str]:
    """Least time of one SpMM direction (K1): the x table and the CSR
    (rowptr, col, w) read once, the output written once, 2 * d f32
    operations for each kept edge (default: every edge); which of bytes
    and operations bounds it.  A frozen copy of ``chip_smoke.py``'s
    ``bound_ms`` with ``tools/timing.py``'s peaks."""
    nbytes = 4 * (n_src * d + (n_dst + 1) + n_edges + n_edges + n_dst * d)
    n_kept = n_edges if n_kept is None else n_kept
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * n_kept * d / PEAK_F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def spmm(n_src: int, n_dst: int, n_edges: int, d: int,
         keep: float) -> Work:
    """One K1 launch's work (see ``bound_ms``)."""
    nbytes = F32 * (n_src * d + n_dst * d) + I32 * (n_dst + 1 + n_edges) \
        + F32 * n_edges
    return Work(2.0 * d * keep * n_edges, nbytes)


def propagation(s: Shape, keep: float) -> Work:
    """One forward propagation: per layer a launch into the users and one
    into the items."""
    layer = (spmm(s.n_items, s.n_users, s.n_edges, s.d, keep)
             + spmm(s.n_users, s.n_items, s.n_edges, s.d, keep))
    return s.n_layers * layer


def k1_mean_bound_ms(s: Shape, keep: float) -> float:
    """``bound_ms`` averaged over the two directions: every propagation,
    forward or backward, launches as many into the users as into the
    items."""
    return 0.5 * (bound_ms(s.n_items, s.n_users, s.n_edges, s.d,
                           keep * s.n_edges)[0]
                  + bound_ms(s.n_users, s.n_items, s.n_edges, s.d,
                             keep * s.n_edges)[0])


def gathers(rows: int, d: int) -> Work:
    """``rows`` rows of width ``d`` gathered from the tables."""
    return Work(0.0, F32 * rows * d)


def adam(s: Shape) -> Work:
    """Adam over both tables: p, g, m, v read; p, m, v written."""
    return Work(0.0, 7 * F32 * (s.n_users + s.n_items) * s.d)


def catalogue_product(n: int, s: Shape) -> Work:
    """``n`` users' rows against the whole item table: 2 * d operations a
    score, the rows read once, the (n, n_items) scores written."""
    return Work(2.0 * n * s.n_items * s.d,
                F32 * (n * s.d + s.n_items * s.d + n * s.n_items))


def lgcn_step(s: Shape, batch: int, neg: int) -> Work:
    """One BPR step: the propagation with dropout, its backward (the
    same launches transposed), the batch's rows from the propagated and
    the layer-0 tables (user, positive, negatives), Adam."""
    prop = propagation(s, s.keep)
    return 2 * prop + 2 * gathers(batch * (2 + neg), s.d) + adam(s)


def adv_step(s: Shape, batch: int, candidates: int, positives: int,
             hard_negs: int) -> Work:
    """One hard-negative step: the rank pass's propagation, the mining
    product, the loss pass's propagation and its backward, the rows of
    the (B, P, K) grid's users, positives and negatives, Adam."""
    prop = propagation(s, s.keep)
    rows = batch * (1 + positives + hard_negs)
    return (3 * prop + catalogue_product(batch, s)
            + 2 * gathers(rows, s.d) + adam(s))


def serve_request(n: int, s: Shape, batch: int, k: int) -> Work:
    """One request of ``n`` users: a propagation without dropout, then
    per batch of up to ``batch`` users the catalogue product, and the
    top-k (an int64 id and a float32 score each) written."""
    w = propagation(s, 1.0)
    for start in range(0, n, batch):
        w = w + catalogue_product(min(batch, n - start), s)
    return w + Work(0.0, n * k * (I64 + F32))
