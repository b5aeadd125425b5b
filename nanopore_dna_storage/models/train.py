"""Flip-flop CRF basecaller training (taiyaki-style CTC loss, optax).

The reference ships only frozen guppy weights (git-LFS blobs, absent in this
mount) and no training code. This module makes the signal path end-to-end
usable: train the flipflop network on (signal, sequence) pairs — e.g. from
the hermetic squiggle simulator — with the standard conditional-likelihood
loss for globally-normalized flip-flop CRFs:

    loss = logZ(all paths) - logsumexp over alignments of the true sequence

The constrained term is a forward pass over the (block, sequence-position)
lattice where position j occupies the CRF state of the j-th base in the
flip/flop state path (ops/synthetic.crf_state_path), moving by stay or
advance — exactly CTC with the flip-flop transition parameterization.

All compute is batched and jitted: the network forward is matmuls +
lax.scan GRUs (models/flipflop.py); both partition functions are lax.scans
over tiny [8]- and [seqlen]-state vectors.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import flipflop as ff
from ..ops.synthetic import crf_state_path
from ..signal.squiggle import simulate_raw_signal
from ..signal.normalize import medmad_normalize

NBASE = 4
NSTATE = 8


def _transition_score_tables(seq_states: jnp.ndarray) -> Tuple[jnp.ndarray,
                                                               jnp.ndarray]:
    """Per-position (stay_row, stay_col) and (move_row, move_col) indices
    into the flat [40] block transitions, for a CRF state path [S]."""
    st = seq_states
    stay_row = jnp.where(st < NBASE, st, NBASE)
    stay_col = st
    prev = jnp.concatenate([st[:1], st[:-1]])  # move into st[j] from st[j-1]
    move_row = jnp.where(st < NBASE, st, NBASE)
    move_col = prev
    return stay_row * NSTATE + stay_col, move_row * NSTATE + move_col


def sequence_log_score(trans: jnp.ndarray, seq_states: jnp.ndarray,
                       nblk: jnp.ndarray, seqlen: jnp.ndarray) -> jnp.ndarray:
    """logsumexp over alignments of the sequence to the blocks.

    trans: [T, 40] raw (unnormalized) block transition weights.
    seq_states: [S] padded CRF state path; seqlen: true length.
    """
    T, S = trans.shape[0], seq_states.shape[0]
    stay_idx, move_idx = _transition_score_tables(seq_states)
    j_ids = jnp.arange(S)
    NEG = -1e30

    def step(c, xs):
        t_blk, act = xs
        stay = c + t_blk[stay_idx]
        move = jnp.concatenate([jnp.full((1,), NEG), c[:-1]]) + t_blk[move_idx]
        new = jnp.logaddexp(stay, move)
        new = jnp.where(act, new, c)
        return new, ()

    # the first block must *enter* the first base: initialize with one
    # pseudo-state before the sequence (position -1 -> move into j=0)
    init = jnp.where(j_ids == 0, 0.0, NEG)
    # first block consumes the stay at j=0 (the read starts inside base 0)
    active = jnp.arange(T) < nblk
    out, _ = jax.lax.scan(step, init, (trans, active))
    return out[jnp.clip(seqlen - 1, 0, S - 1)]


def crf_loss(params, cfg: ff.FlipflopConfig, signal: jnp.ndarray,
             nsamples: jnp.ndarray, seq_states: jnp.ndarray,
             seqlens: jnp.ndarray) -> jnp.ndarray:
    """Mean per-block negative conditional log-likelihood over the batch."""
    x = ff.conv_same_stride(signal[..., None], params["conv_w"],
                            params["conv_b"], cfg.stride)
    x = jnp.tanh(x)
    for i, d in enumerate(cfg.layer_dirs):
        xp = x @ params[f"gru{i}_iw"] + params[f"gru{i}_b"]
        x = jax.vmap(partial(ff.grumod_scan, sw=params[f"gru{i}_sw"],
                             reverse=(d == "b")))(xp)
    # same head scale as inference: shift_scale DIVIDES by temperature/5
    # (flappie layers.c:1084, flappie_matrix.c:625-633)
    trans = jnp.tanh(x @ params["ff_w"] + params["ff_b"]) * \
        (5.0 / cfg.temperature)
    nblk = -(-nsamples // cfg.stride)
    logz = jax.vmap(ff.crf_log_partition)(trans, nblk)
    seq_sc = jax.vmap(sequence_log_score)(trans, seq_states, nblk, seqlens)
    return jnp.mean((logz - seq_sc) / nblk.astype(trans.dtype))


@dataclasses.dataclass
class TrainState:
    params: Dict[str, jnp.ndarray]
    opt_state: object
    step: int = 0


def make_trainer(cfg: ff.FlipflopConfig, learning_rate: float = 1e-3,
                 total_steps: int = 0, warmup: int = 200):
    """``total_steps > 0`` enables a linear-warmup + cosine-decay schedule
    (needed for the larger kmer=6 models; constant Adam at 1e-2 plateaus
    them), else the rate is constant."""
    import optax

    if total_steps:
        sched = optax.warmup_cosine_decay_schedule(
            0.0, learning_rate, min(warmup, total_steps // 10 + 1),
            total_steps, learning_rate * 1e-2)
        opt = optax.adam(sched)
    else:
        opt = optax.adam(learning_rate)

    @jax.jit
    def train_step(params, opt_state, signal, nsamples, seq_states, seqlens):
        loss, grads = jax.value_and_grad(crf_loss)(
            params, cfg, signal, nsamples, seq_states, seqlens)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(seed: int = 0) -> TrainState:
        params = ff.init_params(cfg, seed)
        return TrainState(params, opt.init(params))

    return init, train_step


def synthetic_batches(rng: np.random.Generator, batch: int, seq_len: int,
                      pad_T: int, pad_S: int,
                      kmer: int | None = None) -> Iterator[Tuple]:
    """Endless (signal, nsamples, seq_states, seqlens, seqs) batches from the
    hermetic squiggle simulator. ``kmer`` selects the pore-model context
    length (None = the module default, signal/squiggle.KMER)."""
    kw = {} if kmer is None else {"kmer": kmer}
    while True:
        sigs, states, lens, seqs = [], [], [], []
        for _ in range(batch):
            seq = rng.integers(0, 4, seq_len).astype(np.uint8)
            raw = simulate_raw_signal(seq, rng, deepsim_dwell=False, **kw)
            sigs.append(medmad_normalize(raw)[:pad_T])
            sp = crf_state_path(seq)
            states.append(sp)
            lens.append(len(sp))
            seqs.append(seq)
        ns = np.asarray([len(s) for s in sigs], np.int32)
        sig = np.zeros((batch, pad_T), np.float32)
        st = np.zeros((batch, pad_S), np.int64)
        for i, (s, sp) in enumerate(zip(sigs, states)):
            sig[i, : len(s)] = s
            st[i, : len(sp)] = sp
        yield (jnp.asarray(sig), jnp.asarray(ns), jnp.asarray(st),
               jnp.asarray(lens, jnp.int32), np.asarray(seqs))


def train_on_synthetic(cfg: ff.FlipflopConfig, steps: int, batch: int = 8,
                       seq_len: int = 40, seed: int = 0,
                       learning_rate: float = 1e-3,
                       schedule: bool = False, kmer: int | None = None):
    """Train a model against the hermetic pore model. Returns (state, losses).

    ``kmer`` selects the pore-model context length (None = module default);
    it must match the kmer the trained model will basecall."""
    rng = np.random.default_rng(seed)
    pad_T = seq_len * 12
    init, train_step = make_trainer(cfg, learning_rate,
                                    total_steps=steps if schedule else 0)
    state = init(seed)
    losses = []
    gen = synthetic_batches(rng, batch, seq_len, pad_T, seq_len + 2,
                            kmer=kmer)
    for _ in range(steps):
        sig, ns, st, sl, _ = next(gen)
        state.params, state.opt_state, loss = train_step(
            state.params, state.opt_state, sig, ns, st, sl)
        state.step += 1
        losses.append(float(loss))
    return state, losses
