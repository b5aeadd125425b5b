"""Native host-runtime (libndsio.so) parity with the numpy implementations."""
import numpy as np
import pytest

from nanopore_dna_storage import native
from nanopore_dna_storage.coding.crc import crc8_batch, crc8
from nanopore_dna_storage.signal.barcode import levenshtein_windows


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native build unavailable")


def test_crc8_native_matches_numpy_and_checkvalue():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (50, 23), dtype=np.uint8)
    assert (native.crc8_batch_native(rows) == crc8_batch(rows)).all()
    assert crc8(b"123456789") == 0xF4
    assert native.crc8_batch_native(
        np.frombuffer(b"123456789", np.uint8)[None])[0] == 0xF4


def test_levenshtein_native_matches_numpy():
    rng = np.random.default_rng(1)
    hay = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
    needle = "ACGTACGTAC"
    starts = np.arange(0, 190)
    a = native.levenshtein_windows_native(needle, hay, starts, len(needle))
    b = levenshtein_windows(needle, hay, starts, len(needle))
    assert (a == b).all()


def test_post_batch_loader(tmp_path):
    from nanopore_dna_storage.io.post import write_post

    rng = np.random.default_rng(2)
    paths = []
    posts = []
    for i in range(5):
        p = rng.standard_normal((10 + i, 5, 8)).astype(np.float32)
        path = tmp_path / f"{i}.post"
        write_post(str(path), p)
        posts.append(p)
        paths.append(str(path))
    batch, nblk = native.load_posts_batch(paths, max_blocks=16)
    assert batch.shape == (5, 16, 5, 8)
    for i, p in enumerate(posts):
        assert nblk[i] == p.shape[0]
        np.testing.assert_array_equal(batch[i, : p.shape[0]], p)
        assert (batch[i, p.shape[0]:] == 0).all()
