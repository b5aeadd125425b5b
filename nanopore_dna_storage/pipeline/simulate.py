"""Monte-Carlo end-to-end simulation (the reference's simulator.py and
helper.simulate_and_decode, helper.py:275-351), batched.

Two channel fidelities:

* ``channel``: sequence-level sub/del/ins errors rendered directly into
  synthetic flip-flop posteriors (ops/synthetic.py) — hermetic and fast; the
  default for tests and benchmarks.
* ``signal``: full squiggle synthesis (signal/squiggle.py) -> basecaller
  forward pass -> forward-backward posteriors; exercises the whole signal
  path (needs trained weights for realistic accuracy).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..config import ExperimentConfig
from ..coding import conv as convmod
from ..signal.channel import simulate_indelsubs
from ..ops.synthetic import synthetic_post
from .encode import EncodeResult
from .decode import PipelineDecoder, majority_vote, recover_file


@dataclasses.dataclass
class SimStats:
    num_reads: int = 0
    top_correct: int = 0
    list_correct: int = 0
    crc_pass: int = 0
    unique_indices: int = 0


def simulate_posts(oligos: Sequence[str], num_reads: int,
                   rng: np.random.Generator, *,
                   sub_prob: float = 0.004, del_prob: float = 0.0085,
                   ins_prob: float = 0.0005, noise: float = 1.0,
                   stay_prob: float = 0.35):
    """Sample reads (random oligo, random orientation), apply channel errors,
    render synthetic posteriors. Returns (posts, rc_flags, oligo_ids)."""
    posts: List[np.ndarray] = []
    rcs: List[bool] = []
    ids: List[int] = []
    arr = convmod.str_to_bases(list(oligos))
    for _ in range(num_reads):
        oid = int(rng.integers(len(oligos)))
        rc = bool(rng.integers(2))
        bases = arr[oid]
        noisy = simulate_indelsubs(bases if not rc else
                                   convmod.reverse_complement_bases(bases),
                                   rng, sub_prob, del_prob, ins_prob)
        # the emitted read is already oriented; synthetic_post without extra rc
        posts.append(synthetic_post(noisy, rng, rc=False, noise=noise,
                                    stay_prob=stay_prob))
        rcs.append(rc)
        ids.append(oid)
    return posts, np.asarray(rcs), np.asarray(ids)


def simulate_posts_signal(oligos: Sequence[str], num_reads: int,
                          rng: np.random.Generator, params, model_cfg, *,
                          kmer: int = 6, deepsim_dwell: bool = False,
                          profile=None):
    """Signal-fidelity read simulation: squiggle synthesis -> basecaller
    forward pass -> forward-backward transition posteriors.

    The full simulator.py loop (simulator.py:59-116): random oligo, random
    orientation, raw signal from the pore model, medmad normalize, the
    flip-flop network, transpost — everything the real decode consumes,
    with no synthetic-posterior shortcut. Returns (posts, rc_flags, ids).

    ``profile`` (signal/squiggle.ChannelProfile) injects real-data
    failure modes: junk (unaligned-analog) and chimeric reads carry
    id=-1 — they are never countable as correct, like real reads that
    align to no oligo — plus untrimmed flank bases and the profile's
    burst/drift signal degradations.
    """
    import jax.numpy as jnp

    from ..models.flipflop import flipflop_transitions
    from ..ops.fwdbwd import batched_transition_posteriors
    from ..signal.normalize import medmad_normalize
    from ..signal.squiggle import simulate_raw_signal

    arr = convmod.str_to_bases(list(oligos))
    raws, rcs, ids = [], [], []
    for _ in range(num_reads):
        oid = int(rng.integers(len(oligos)))
        rc = bool(rng.integers(2))
        bases = arr[oid] if not rc else convmod.reverse_complement_bases(
            arr[oid])
        if profile is not None:
            u = rng.random()
            if u < profile.junk_frac:
                # unaligned-read analog: unrelated sequence of this length
                bases = rng.integers(0, 4, len(bases)).astype(bases.dtype)
                oid = -1
            elif u < profile.junk_frac + profile.chimeric_frac:
                # chimera: prefix of this read + suffix of another
                o2 = int(rng.integers(len(oligos)))
                b2 = arr[o2] if not rng.integers(2) else \
                    convmod.reverse_complement_bases(arr[o2])
                cut = int(rng.integers(len(bases) // 5,
                                       4 * len(bases) // 5 + 1))
                bases = np.concatenate(
                    [bases[:cut], b2[len(b2) - (len(bases) - cut):]])
                oid = -1
            if profile.flank_bases > 0:
                pre = rng.integers(0, 4, rng.integers(
                    0, profile.flank_bases + 1)).astype(bases.dtype)
                post_fl = rng.integers(0, 4, rng.integers(
                    0, profile.flank_bases + 1)).astype(bases.dtype)
                bases = np.concatenate([pre, bases, post_fl])
        raw = simulate_raw_signal(bases, rng, deepsim_dwell=deepsim_dwell,
                                  kmer=kmer, profile=profile)
        raws.append(medmad_normalize(raw))
        rcs.append(rc)
        ids.append(oid)
    T = -(-max(len(r) for r in raws) // 16) * 16
    sig = np.zeros((num_reads, T), np.float32)
    ns = np.zeros(num_reads, np.int32)
    for i, r in enumerate(raws):
        sig[i, : len(r)] = r
        ns[i] = len(r)
    trans = flipflop_transitions(params, model_cfg, jnp.asarray(sig),
                                 jnp.asarray(ns))
    nblk = -(-ns // model_cfg.stride)
    posts = np.asarray(batched_transition_posteriors(
        trans.reshape(num_reads, -1, 40), jnp.asarray(nblk)))
    return ([posts[i, : nblk[i]] for i in range(num_reads)],
            np.asarray(rcs), np.asarray(ids))


def simulate_and_decode_signal(enc: EncodeResult, exp: ExperimentConfig,
                               num_reads: int, *, list_size: int = 8,
                               seed: int = 0,
                               max_deviation: Optional[int] = 20,
                               train_steps: int = 300, kmer: int = 1,
                               model_cfg=None, params=None,
                               learning_rate: float = 1e-2,
                               lr_schedule: bool = False,
                               batch: int = 16, train_seq_len: int = 40,
                               profile=None, **decode_kw):
    """End-to-end SIGNAL-fidelity Monte-Carlo decode accuracy.

    Trains a basecaller from scratch on the hermetic pore model (unless
    trained params are supplied), then runs
    msg -> conv encode -> squiggle -> basecaller -> fwd-bwd -> list-Viterbi
    -> CRC/index classification and reports per-read accuracy — the
    simulator.py:59-116 loop at signal fidelity. Returns SimStats.

    kmer=1 keeps the basecaller trainable in seconds (see
    signal/squiggle.py); pass kmer=6 + longer training for the production
    pore model.
    """
    from ..models import flipflop as ff
    from ..models import train as trainmod

    if model_cfg is None:
        model_cfg = ff.FlipflopConfig(winlen=7, stride=2, conv_filters=16,
                                      hidden=32, layer_dirs=("b", "f"))
    if params is None:
        state, _ = trainmod.train_on_synthetic(
            model_cfg, steps=train_steps, batch=8,
            seq_len=train_seq_len, seed=seed,
            learning_rate=learning_rate, schedule=lr_schedule, kmer=kmer)
        params = state.params

    rng = np.random.default_rng(seed + 1)
    dec = PipelineDecoder(exp, list_size, max_deviation, **decode_kw)
    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    oligo_msgs = {}  # oligo id -> true message bits
    stats = SimStats()
    seen = set()
    for lo in range(0, num_reads, batch):
        n = min(batch, num_reads - lo)
        posts, rcs, ids = simulate_posts_signal(
            enc.oligos, n, rng, params, model_cfg, kmer=kmer,
            profile=profile)
        out = dec.decode_posts(posts, rcs, num_oligos)
        stats.num_reads += n
        stats.crc_pass += int((out.index >= 0).sum())
        for j in range(n):
            if out.index[j] < 0 or int(out.index[j]) != int(ids[j]):
                continue
            stats.list_correct += 1
            seen.add(int(ids[j]))
            # top = the CRC-passing candidate sits in list slot 0
            if out.valid[j, 0] and (out.msgs[j, 0]
                                    == out.chosen_msg[j]).all():
                stats.top_correct += 1
    stats.unique_indices = len(seen)
    return stats, params


def simulate_and_decode(enc: EncodeResult, exp: ExperimentConfig,
                        num_reads: int, data_size: int, *,
                        list_size: int = 8, seed: int = 0,
                        sub_prob: float = 0.004, del_prob: float = 0.0085,
                        ins_prob: float = 0.0005,
                        max_deviation: Optional[int] = 20,
                        batch: int = 32, auto_orientation: bool = False):
    """Full loop: sample reads -> decode -> CRC/index -> vote -> RS -> bytes.

    ``auto_orientation`` decodes without the simulator's orientation flags
    (CRC-gated, ``PipelineDecoder.decode_posts_auto_orientation``), as for
    reads that arrive without a basecall. Returns (ok, recovered_bytes,
    SimStats).
    """
    rng = np.random.default_rng(seed)
    dec = PipelineDecoder(exp, list_size, max_deviation)
    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    stats = SimStats()
    all_idx: List[np.ndarray] = []
    all_payload: List[np.ndarray] = []
    for lo in range(0, num_reads, batch):
        n = min(batch, num_reads - lo)
        posts, rcs, ids = simulate_posts(enc.oligos, n, rng,
                                         sub_prob=sub_prob,
                                         del_prob=del_prob,
                                         ins_prob=ins_prob)
        if auto_orientation:
            out, _ = dec.decode_posts_auto_orientation(posts, num_oligos)
        else:
            out = dec.decode_posts(posts, rcs, num_oligos)
        stats.num_reads += n
        stats.crc_pass += int((out.index >= 0).sum())
        all_idx.append(out.index)
        all_payload.append(out.payload)
    indices = np.concatenate(all_idx)
    payloads = np.concatenate(all_payload)
    voted = majority_vote(indices, payloads)
    stats.unique_indices = len(voted)
    ok, data = recover_file(voted, exp, data_size)
    return ok, data, stats
