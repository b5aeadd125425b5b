"""Data-prep utilities: archives, SAM parsing, sharding, accuracy stats."""
import numpy as np

from nanopore_dna_storage.io import fast5 as fast5_io
from nanopore_dna_storage.pipeline.data_prep import (
    parse_sam_mappings, build_raw_signal_archive, sample_read_ids,
    shard_read_ids, basecall_accuracy,
)


def test_fast5_roundtrip_and_archive(tmp_path):
    rng = np.random.default_rng(0)
    raws = {}
    for i in range(3):
        raw = rng.normal(500, 40, 800 + 50 * i).astype(np.float32)
        fast5_io.write_fast5(str(tmp_path / f"r{i}.fast5"), raw)
        raws[i] = raw
    # single-read read-back approximates the original (quantized)
    back = fast5_io.read_fast5_raw(str(tmp_path / "r0.fast5"))
    assert back.shape == raws[0].shape
    corr = np.corrcoef(back, raws[0])[0, 1]
    assert corr > 0.999

    n = build_raw_signal_archive(str(tmp_path), str(tmp_path / "arch.h5"))
    assert n == 3
    ids = sample_read_ids(str(tmp_path / "arch.h5"), 2, seed=1)
    assert len(ids) == 2
    shards = shard_read_ids(ids, 2)
    assert sorted(sum(shards, [])) == sorted(ids)


def test_sam_parsing(tmp_path):
    sam = tmp_path / "a.sam"
    sam.write_text(
        "@HD\tVN:1.6\n"
        "read1\t0\toligo_5\t1\t60\t10M\t*\t0\t0\tACGTACGTAC\t*\n"
        "read2\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"  # unmapped
        "read3\t256\toligo_2\t1\t0\t4M\t*\t0\t0\tACGT\t*\n"  # secondary
    )
    m = parse_sam_mappings(str(sam))
    assert m == {"read1": "oligo_5"}


def test_basecall_accuracy():
    stats = basecall_accuracy(
        {"a": "ACGTACGT", "b": "ACGT", "c": "TTTT"},
        {"a": "ACGTACGT", "b": "ACGG"})
    assert stats["compared"] == 2
    assert stats["unaligned"] == 1
    assert abs(stats["error_rate"] - 1 / 12) < 1e-9
    assert abs(stats["sub_rate"] - 1 / 12) < 1e-9
    assert stats["ins_rate"] == 0 and stats["del_rate"] == 0


def test_align_counts_breakdown():
    from nanopore_dna_storage.pipeline.data_prep import align_counts
    from nanopore_dna_storage.signal.barcode import levenshtein

    # substitution / insertion / deletion each classified correctly
    assert align_counts("ACGT", "ACCT") == {"sub": 1, "ins": 0, "del": 0}
    assert align_counts("ACGGT", "ACGT") == {"sub": 0, "ins": 1, "del": 0}
    assert align_counts("ACT", "ACGT") == {"sub": 0, "ins": 0, "del": 1}
    # total always equals the edit distance
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = "".join(rng.choice(list("ACGT"), rng.integers(0, 12)))
        b = "".join(rng.choice(list("ACGT"), rng.integers(0, 12)))
        c = align_counts(a, b)
        assert c["sub"] + c["ins"] + c["del"] == levenshtein(a, b), (a, b)
