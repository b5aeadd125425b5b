"""Sharded data-parallel decode on the 8-device CPU mesh: results must match
the single-device decoder, and the on-device CRC/index classification must
match the host-side framing check."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")


@pytest.mark.slow
def test_sharded_decoder_matches_single_device():
    from nanopore_dna_storage.config import ExperimentConfig
    from nanopore_dna_storage.pipeline.encode import encode_bytes
    from nanopore_dna_storage.pipeline.simulate import simulate_posts
    from nanopore_dna_storage.pipeline.decode import PipelineDecoder
    from nanopore_dna_storage.parallel.mesh import ShardedDecoder, data_mesh
    from nanopore_dna_storage.io.post import pack_posts
    from nanopore_dna_storage.coding.framing import check_and_extract

    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    enc = encode_bytes(bytes(range(16)), exp)
    rng = np.random.default_rng(1)
    posts, rcs, _ = simulate_posts(enc.oligos, 8, rng, sub_prob=0.002,
                                   del_prob=0.002, ins_prob=0.0)
    batch, nblks = pack_posts(posts, bucket=32)
    total = enc.num_oligos_data + enc.num_oligos_rs

    sel = np.nonzero(~rcs)[0]
    if len(sel) < 2:
        sel = np.arange(4)
    mesh = data_mesh()
    sharded = ShardedDecoder(exp, list_size=2, rc=False, max_deviation=None,
                             mesh=mesh)
    res = sharded.decode(batch[sel], nblks[sel], total)

    single = PipelineDecoder(exp, list_size=2, max_deviation=None)
    out = single.decode_posts([posts[i] for i in sel], [False] * len(sel),
                              total)
    # identical decoded bits
    assert (res.msgs == out.msgs).all()
    # device-side CRC/index == host-side framing check
    ok_host, idx_host = check_and_extract(out.msgs, exp.framing, total,
                                          pad=exp.pad)
    ok_host &= out.valid
    assert (res.ok == ok_host).all()
    assert (res.index[res.ok] == idx_host[res.ok]).all()
    assert res.crc_pass_total == int(ok_host.any(axis=1).sum())


@pytest.mark.slow
def test_sharded_decoder_traceback_backend():
    """The PRODUCTION path: ShardedDecoder dispatching through the
    traceback chunk programs under shard_map over the 8-device mesh.
    Results must match the single-device decode bit-for-bit."""
    from nanopore_dna_storage.config import ExperimentConfig
    from nanopore_dna_storage.pipeline.encode import encode_bytes
    from nanopore_dna_storage.pipeline.simulate import simulate_posts
    from nanopore_dna_storage.pipeline.decode import PipelineDecoder
    from nanopore_dna_storage.parallel.mesh import ShardedDecoder, data_mesh
    from nanopore_dna_storage.io.post import pack_posts

    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    enc = encode_bytes(bytes(range(16)), exp)
    rng = np.random.default_rng(3)
    posts, rcs, _ = simulate_posts(enc.oligos, 8, rng, sub_prob=0.002,
                                   del_prob=0.002, ins_prob=0.0)
    batch, nblks = pack_posts(posts, bucket=32)
    total = enc.num_oligos_data + enc.num_oligos_rs

    mesh = data_mesh()
    sharded = ShardedDecoder(exp, list_size=2, rc=False, max_deviation=12,
                             mesh=mesh, backend="traceback",
                             chunk_blocks=32)
    res = sharded.decode(batch, nblks, total)

    single = PipelineDecoder(exp, list_size=2, max_deviation=12,
                             backend="traceback")
    out = single.decode_posts(posts, [False] * len(posts), total)
    assert (res.msgs[res.ok] == out.msgs[out.valid & res.ok]).all()
    assert (res.msgs == out.msgs).all()
    assert res.crc_pass_total == int((out.valid
                                      & res.ok).any(axis=1).sum())


@pytest.mark.slow
def test_sharded_decoder_traceback_m11_shapes():
    """Production m=11 SHAPES through the sharded traceback path on the
    CPU mesh: conv state space C=2048, list size 8, int8 selection codes,
    a real beam — everything the device m=11 decode exercises except
    scale. A short payload (bytes_per_oligo=2, pad -> msg_len 37) keeps the
    CPU runtime in slow-suite bounds; the shape-relevant axes are
    untouched. Sharded results must equal the single-device decode
    bit-for-bit."""
    from nanopore_dna_storage.config import ExperimentConfig
    from nanopore_dna_storage.pipeline.encode import encode_bytes
    from nanopore_dna_storage.pipeline.simulate import simulate_posts
    from nanopore_dna_storage.pipeline.decode import PipelineDecoder
    from nanopore_dna_storage.parallel.mesh import ShardedDecoder, data_mesh
    from nanopore_dna_storage.io.post import pack_posts

    exp = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5,
                           conv_mem=11, conv_rate=5, pad=True)
    enc = encode_bytes(bytes(range(8)), exp)
    rng = np.random.default_rng(7)
    posts, rcs, _ = simulate_posts(enc.oligos, 8, rng, sub_prob=0.002,
                                   del_prob=0.002, ins_prob=0.0)
    batch, nblks = pack_posts(posts, bucket=32)
    total = enc.num_oligos_data + enc.num_oligos_rs

    sharded = ShardedDecoder(exp, list_size=8, rc=False, max_deviation=8,
                             mesh=data_mesh(), backend="traceback",
                             chunk_blocks=16)
    res = sharded.decode(batch, nblks, total)

    single = PipelineDecoder(exp, list_size=8, max_deviation=8,
                             backend="traceback", chunk_blocks=16)
    out = single.decode_posts(posts, [False] * len(posts), total)
    assert (res.msgs == out.msgs).all()
    assert res.crc_pass_total == int((out.valid
                                      & res.ok).any(axis=1).sum())
