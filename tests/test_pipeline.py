"""End-to-end file recovery: encode -> simulated channel -> batched LVA ->
CRC/index -> majority vote -> RS -> byte-exact file comparison (the
reference's commented self-test, helper.py:389-395, as a real test)."""
import numpy as np
import pytest

from nanopore_dna_storage.config import ExperimentConfig
from nanopore_dna_storage.pipeline.encode import encode_bytes
from nanopore_dna_storage.pipeline.simulate import simulate_and_decode
from nanopore_dna_storage.pipeline.decode import (
    PipelineDecoder, majority_vote, recover_file,
)


def test_encode_shapes_and_rate():
    exp = ExperimentConfig(bytes_per_oligo=12, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    data = bytes(range(120))
    enc = encode_bytes(data, exp)
    assert enc.num_oligos_data == 10
    assert enc.num_oligos_rs == 5
    assert len(enc.oligos) == 15
    # rate 1/2: msg_len 116 bits + mem 6 = 122 input bits -> 122 bases
    assert enc.oligo_len == exp.msg_len() + 6
    assert all(set(o) <= set("ACGT") for o in enc.oligos)


@pytest.mark.slow
def test_end_to_end_file_recovery():
    exp = ExperimentConfig(bytes_per_oligo=6, rs_redundancy=0.6,
                           conv_mem=6, conv_rate=1)
    data = b"nanopore DNA storage"  # 20 bytes -> 4 data oligos
    enc = encode_bytes(data, exp)
    ok, recovered, stats = simulate_and_decode(
        enc, exp, num_reads=40, data_size=len(data), list_size=2, seed=3,
        sub_prob=0.003, del_prob=0.004, ins_prob=0.0005, batch=20)
    assert stats.crc_pass > 0
    assert ok
    assert recovered == data


def test_gated_auto_orientation():
    """CRC-gated orientation pick (fwd first, RC only for CRC failures)
    recovers the same per-read index/payload as decoding both orientations,
    while re-decoding only the fwd-CRC-failure subset (the reference
    decodes each read once, orientation pre-picked,
    generate_decoded_lists.py:68-82)."""
    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    data = bytes(range(16))
    enc = encode_bytes(data, exp)
    from nanopore_dna_storage.pipeline.simulate import simulate_posts
    rng = np.random.default_rng(1)
    posts, rcs, ids = simulate_posts(enc.oligos, 10, rng, sub_prob=0,
                                     del_prob=0, ins_prob=0)
    assert rcs.any() and (~rcs).any()  # both orientations present
    dec = PipelineDecoder(exp, list_size=2, max_deviation=16)
    total = enc.num_oligos_data + enc.num_oligos_rs
    out_g, rc_g = dec.decode_posts_auto_orientation(posts, total)
    out_b, rc_b = dec.decode_posts_auto_orientation(posts, total,
                                                    gated=False)
    # error-free reads all decode; gated and both-ways agree on the
    # recovered (index, payload) wherever either passes CRC
    assert (out_g.index >= 0).all()
    assert (out_g.index == out_b.index).all()
    assert (out_g.payload == out_b.payload).all()
    # the gated path marks exactly the truly-RC reads (fwd CRC fails on
    # an RC read, passes on a fwd read, for error-free posts)
    assert (rc_g == rcs).all()


def test_error_free_single_batch_decode():
    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    data = bytes(range(16))
    enc = encode_bytes(data, exp)
    from nanopore_dna_storage.pipeline.simulate import simulate_posts
    rng = np.random.default_rng(0)
    posts, rcs, ids = simulate_posts(enc.oligos, 12, rng, sub_prob=0,
                                     del_prob=0, ins_prob=0)
    dec = PipelineDecoder(exp, list_size=1, max_deviation=None)
    total = enc.num_oligos_data + enc.num_oligos_rs
    out = dec.decode_posts(posts, rcs, total)
    assert (out.index >= 0).all()
    # recovered payloads must match the encoded ones for each sampled oligo
    voted = majority_vote(out.index, out.payload)
    ok, rec = recover_file(voted, exp, len(data))
    if len(voted) >= enc.num_oligos_data:  # enough coverage
        assert ok and rec == data


def test_simulate_and_decode_auto_orientation():
    """The full loop without the simulator's orientation flags: CRC-gated
    auto-orientation decode -> vote -> RS recovers the file."""
    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    data = bytes(range(16))
    enc = encode_bytes(data, exp)
    ok, recovered, stats = simulate_and_decode(
        enc, exp, num_reads=24, data_size=len(data), list_size=2, seed=2,
        sub_prob=0.0, del_prob=0.0, ins_prob=0.0, max_deviation=16,
        batch=12, auto_orientation=True)
    assert stats.crc_pass == stats.num_reads == 24
    assert ok and recovered == data
