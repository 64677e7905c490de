"""Row-gather lab on the card: how fast the H100 gathers random rows of a
table, by ordinary loads and by one bulk asynchronous copy per row.

    python -m textgcn_tpu_torch.tools.gather_lab [onehot dma]

Counterpart of ``tools/gather_lab.py``, whose two mode names are kept so
that each finds its TPU kernel; on the card neither mode is a one-hot:

* ``onehot`` (L2) -- ``out[i] = x[ids_p[i]]`` by ordinary vector loads
  (``gather_rows_cuda``): 600,064 ids in [0, 25,000), sorted and
  block-padded as the TPU kernel takes them
  (``lab_layout.block_padded_ids``: 602,880 rows), x (25,088, 64) f32;
* ``dma`` (L3) -- ``out[i] = x[ids[i]]`` for the first 131,072 unsorted
  ids, each row fetched by one ``cp.async.bulk`` (the TMA engine's 1-D
  bulk copy) into shared memory, 128 in flight a block, then stored
  (``gather_rows_bulk_cuda``); x (25,088, 128) f32.

Both kernels are in ``csrc/gather_lab.cu`` and count their launches in
``.launches``; ``gather_rows_plain`` (``index_select``) is their plain
version.  The ids and the x tables come from ``np.random.RandomState(0)``
in the JAX lab's order: the ids, then one x per mode run.  On the card
the lab prints ms per call, rows/ms, the bound and the share of it
reached; without a card it raises unless ``TEXTGCN_TPU_PLATFORM=cpu``,
where it runs the plain version once per mode and prints checksums.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from ..config import platform_device
from .lab_layout import block_padded_ids
from .timing import bound_ms, log, nvidia_smi, time_ms

N_ROWS = 600_064     # ids gathered per onehot call
N_SRC = 25_000       # rows of the source table
D = 64               # onehot row width
C = 128              # ids per chunk
SB = 512             # source block rows (onehot padding)
DMA_ROWS = 131_072   # ids gathered per dma call
DMA_D = 128          # dma row width
MODES = ('onehot', 'dma')
KERNEL_SOURCE = 'gather_lab.cu'


def lab_ids():
    """``(ids, rng)``: the lab's ``N_ROWS`` random ids and the stream the
    x tables come from next."""
    rng = np.random.RandomState(0)
    return rng.randint(0, N_SRC, N_ROWS).astype(np.int32), rng


def mode_ids(ids: np.ndarray, mode: str) -> np.ndarray:
    """The ids a mode gathers: sorted and block-padded for ``onehot``;
    the first ``DMA_ROWS``, cut to a multiple of ``C``, for ``dma``."""
    if mode == 'onehot':
        return block_padded_ids(np.sort(ids), SB, C)
    ids = ids[:DMA_ROWS]
    return ids[:len(ids) // C * C]


def lab_x(rng, d: int) -> torch.Tensor:
    """The next x of the stream: ``N_SRC`` rows of N(0, 1) at width
    ``d``, zero rows up to a multiple of ``SB``, float32."""
    x = np.zeros((-(-N_SRC // SB) * SB, d), np.float32)
    x[:N_SRC] = rng.randn(N_SRC, d)
    return torch.from_numpy(x)


def _check_args(x: torch.Tensor, ids: torch.Tensor):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f'x must be 2-d float32, got {x.dtype} '
                         f'{tuple(x.shape)}')
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f'ids must be 1-d int32, got {ids.dtype} '
                         f'{tuple(ids.shape)}')
    if ids.device != x.device:
        raise ValueError(f'ids on {ids.device}, x on {x.device}')


def gather_rows_plain(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain version of L2 and L3: ``x.index_select(0, ids)``."""
    _check_args(x, ids)
    return x.index_select(0, ids)


@functools.cache
def _kernel_fns():
    """The two C entry points, built and bound at first use."""
    from .. import cuda_build
    lib = cuda_build.load(KERNEL_SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    rows, bulk = lib.gather_rows_f32, lib.gather_rows_bulk_f32
    rows.argtypes = [vp, vp, vp, ctypes.c_int64, ci, ci, vp]
    bulk.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    rows.restype = bulk.restype = ci
    return {False: rows, True: bulk}


def _launch(bulk: bool, name: str, x: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    _check_args(x, ids)
    if x.device.type != 'cuda':
        raise ValueError(f'{name} needs CUDA tensors, x is on {x.device}')
    d = x.shape[1]
    if d == 0 or d % 4:
        raise ValueError(f'the kernel takes d a positive multiple of 4, '
                         f'got d={d}')
    if bulk and d > 448:
        raise ValueError(f'the bulk kernel takes d <= 448, got d={d}')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError('x must be contiguous and 16-byte aligned')
    if not ids.is_contiguous():
        raise ValueError('ids must be contiguous')
    n = ids.numel()
    if bulk and n >= 2**31:
        raise ValueError(f'the bulk kernel takes < 2^31 ids, got {n}')
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fns()[bulk](x.data_ptr(), ids.data_ptr(), out.data_ptr(),
                             n, d, x.device.index or 0, stream)
    if rc:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')
    return out


def gather_rows_cuda(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch L2 (vector loads) on PyTorch's current stream: ``out[i] =
    x[ids[i]]``, ids in range (not checked: that would wait for the
    card).  Raises on anything the kernel does not take."""
    out = _launch(False, 'gather_rows_cuda', x, ids)
    if ids.numel():
        gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def gather_rows_bulk_cuda(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch L3 (one bulk asynchronous copy per row) on PyTorch's
    current stream, as ``gather_rows_cuda``; d <= 448."""
    out = _launch(True, 'gather_rows_bulk_cuda', x, ids)
    if ids.numel():
        gather_rows_bulk_cuda.launches += 1
    return out


gather_rows_bulk_cuda.launches = 0


def gather_bound(x: torch.Tensor, ids: torch.Tensor) -> tuple[float, str,
                                                               float]:
    """``(ms, 'bytes', bytes)``: the least time of one gather on the
    card: the ids and each distinct row of x read once, the output
    written once; it does no arithmetic."""
    rows = int(torch.unique(ids).numel())
    nbytes = 4 * ids.numel() + (rows + ids.numel()) * x.shape[1] * 4
    ms, by = bound_ms(nbytes, 0)
    return ms, by, nbytes


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Run the modes named in ``argv`` (default both) and return ``{mode:
    result}``: on the card ``ms``, ``rows``, ``bound_ms``, ``bound_by``
    and ``bytes``; on the CPU ``checksum``."""
    modes = list(sys.argv[1:] if argv is None else argv) or list(MODES)
    bad = [m for m in modes if m not in MODES]
    if bad:
        raise SystemExit(f'unknown mode(s) {bad}: choose from {MODES}')
    dev = platform_device()
    if dev.type == 'cuda':
        log(nvidia_smi('name,power.limit'))
    ids_all, rng = lab_ids()
    results = {}
    for mode in modes:
        ids = torch.from_numpy(mode_ids(ids_all, mode)).to(dev)
        x = lab_x(rng, D if mode == 'onehot' else DMA_D).to(dev)
        n = ids.numel()
        if dev.type == 'cpu':
            out = gather_rows_plain(x, ids)
            results[mode] = {'checksum': float(out.double().sum())}
            log(f'{mode:8s}: plain on the CPU, {n:,} rows of '
                f'{x.shape[1]}, checksum {results[mode]["checksum"]:.6f}')
            continue
        kernel = (gather_rows_cuda if mode == 'onehot'
                  else gather_rows_bulk_cuda)
        ms = time_ms({mode: lambda: kernel(x, ids)}, [mode, mode],
                     strict=(mode,))[mode]
        b, by, nbytes = gather_bound(x, ids)
        results[mode] = {'ms': ms, 'rows': n, 'bound_ms': b,
                         'bound_by': by, 'bytes': nbytes}
        log(f'{mode:8s}: {ms:.4f} ms / {n:,} rows of {x.shape[1]} '
            f'({n / ms / 1e3:,.1f}k rows/ms), bound {b:.4f} ms '
            f'({nbytes / 1e6:.1f} MB), {b / ms:.3f} of it')
    return results


if __name__ == '__main__':
    main()
