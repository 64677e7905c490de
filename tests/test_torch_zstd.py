"""The port's Zstandard decoder (``textgcn_tpu_torch/zstd.py``,
``csrc/zstd_decode.cpp``) against ``zstandard``, on the CPU.

The decoder reads the zarr chunks and OCDBT nodes of the JAX package's
Orbax checkpoints; ``zstandard`` (a test dependency of the CPU tests, never
imported by the port) writes the frames here:

* a hypothesis property over random bytes, float32 tables, zeros and
  text, at levels -5 to 22, with and without a content checksum and a
  content size: the decoded bytes equal the input;
* inputs of several 128 KiB blocks, a streamed frame without a content
  size, concatenated frames and skippable frames between them;
* truncation at every offset and flipped bytes raise ``ValueError`` with
  the input offset and never crash; a checksum mismatch, an unknown
  magic, a reserved block type and the output limit are named;
* a frame that names a dictionary is refused;
* CRC-32C against its published check value.
"""

import numpy as np
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch import zstd

WORDS = ('user item graph table shard orbax zarr chunk layer the of and '
         'embedding propagation recall').split()


def _frame(data: bytes, level: int = 3, checksum: bool = True,
           size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=size).compress(data)


@st.composite
def payloads(draw):
    kind = draw(st.sampled_from(['bytes', 'f32', 'zeros', 'text']))
    n = draw(st.integers(0, 40_000))
    if kind == 'bytes':
        return draw(st.binary(max_size=n // 4))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    if kind == 'f32':
        scale = draw(st.sampled_from([1e-3, 0.1, 1.0, 1e4]))
        return (scale * rng.standard_normal(n // 4)).astype(
            np.float32).tobytes()
    if kind == 'zeros':
        return bytes(n)
    return ' '.join(rng.choice(WORDS, n // 6)).encode()


@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=payloads(), level=st.integers(-5, 22), checksum=st.booleans(),
       size=st.booleans())
def test_decodes_what_zstandard_writes(data, level, checksum, size):
    assert zstd.decompress(_frame(data, level, checksum, size)) == data


@pytest.mark.parametrize('level', [-5, 1, 3, 9, 19, 22])
def test_multi_block_tables(level):
    """Tables of the JAX package's shape: float32 rows of 64, several
    128 KiB blocks (a row-shard chunk of S1 is 15,360 rows)."""
    rng = np.random.default_rng(level + 10)
    table = (0.1 * rng.standard_normal((2048, 64))).astype(np.float32)
    table[::7] = 0.0
    data = table.tobytes()
    assert zstd.decompress(_frame(data, level)) == data


def test_streamed_frame_without_content_size():
    rng = np.random.default_rng(1)
    data = b''.join(rng.choice(WORDS, 50_000).astype('S').tolist())
    cobj = zstandard.ZstdCompressor(level=5,
                                    write_checksum=True).compressobj()
    frame = b''.join(cobj.compress(data[i:i + 9_000])
                     for i in range(0, len(data), 9_000)) + cobj.flush()
    assert zstd.decompress(frame) == data


def _skippable(n: int, magic_low: int = 0) -> bytes:
    return ((0x184D2A50 + magic_low).to_bytes(4, 'little')
            + n.to_bytes(4, 'little') + bytes(i % 256 for i in range(n)))


def test_concatenated_and_skippable_frames():
    parts = [b'first frame ' * 50, b'', np.arange(5000, dtype=np.float32)
             .tobytes(), b'last']
    frames = [_skippable(0), _frame(parts[0], 1), _skippable(7, 15),
              _frame(parts[1], 3, size=False), _frame(parts[2], 19),
              _skippable(300, 3), _frame(parts[3], -5, checksum=False)]
    assert zstd.decompress(b''.join(frames)) == b''.join(parts)


def test_truncations_raise_with_the_offset():
    frame = _frame(open(zstd.SOURCE, 'rb').read()[:6000], 9)
    for cut in range(len(frame)):
        with pytest.raises(ValueError, match=r'\(input offset \d+\)'):
            zstd.decompress(frame[:cut])


def test_flipped_bytes_in_a_checksummed_frame_raise():
    """A flipped byte in a checksummed frame is found: by the checksum or
    by the structure it breaks.  Nothing crashes or hangs."""
    rng = np.random.default_rng(2)
    data = (0.5 * rng.standard_normal(3000)).astype(np.float32).tobytes()
    frame = bytearray(_frame(data, 7))
    for pos in rng.integers(4, len(frame), 300):
        bad = bytearray(frame)
        bad[pos] ^= 1 << int(rng.integers(8))
        with pytest.raises(ValueError, match='zstd: '):
            zstd.decompress(bytes(bad), limit=len(data))


def test_named_faults():
    frame = _frame(b'abc' * 1000, 3)
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match='content checksum mismatch'):
        zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match=r'not a zstd frame \(magic '
                       r'04034b50\) \(input offset 0\)'):
        zstd.decompress(b'PK\x03\x04rest')
    with pytest.raises(ValueError, match='no zstd frame'):
        zstd.decompress(b'')
    raw = _frame(bytes(100), checksum=False)
    with pytest.raises(ValueError, match='exceeds the limit of 99 bytes'):
        zstd.decompress(raw, limit=99)
    assert zstd.decompress(raw, limit=100) == bytes(100)
    # a block header of type 3 after a single-segment header of size 1
    reserved = b'\x28\xb5\x2f\xfd\x20\x01' + ((1 << 3) | (3 << 1) | 1
                                              ).to_bytes(3, 'little') + b'x'
    with pytest.raises(ValueError, match=r'reserved block type \(input '
                       r'offset 6\)'):
        zstd.decompress(reserved)


def test_a_dictionary_frame_is_refused():
    samples = [(' '.join(np.random.default_rng(i).choice(WORDS, 40))
                ).encode() for i in range(400)]
    d = zstandard.train_dictionary(2048, samples)
    assert d.dict_id() != 0
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    with pytest.raises(ValueError, match=f'names dictionary {d.dict_id()}: '
                       'dictionaries are not supported'):
        zstd.decompress(frame)
    # the dictionary id field in each of its three widths
    for flag, width in ((1, 1), (2, 2), (3, 4)):
        head = b'\x28\xb5\x2f\xfd' + bytes([0x20 | flag]) + (
            7).to_bytes(width, 'little') + b'\x05'
        with pytest.raises(ValueError, match='names dictionary 7'):
            zstd.decompress(head + b'\x01\x00\x00')


def test_crc32c_matches_its_check_value():
    assert zstd.crc32c(b'123456789') == 0xE3069283
    assert zstd.crc32c(b'') == 0
