"""Flip-flop basecaller network — JAX/Flax-free functional implementation.

JAX rebuild of the flappie guppy flip-flop architecture
(flappie/src/networks.c:301-340): conv(winlen, stride) + tanh, then five
modified-GRU layers alternating backward/forward/backward/forward/backward,
then the globally-normalized CRF transition head (layers.c:1080-1101).

Design notes (vs the reference C):
* The reference runs one read at a time through BLAS sgemv per timestep
  (layers.c:648-699). Here the input projections of every layer are batched
  matmuls over (reads x time) — tensor-core work — and only the 3h x h recurrent
  matvec lives inside ``lax.scan``; reads are vmapped so the scan matvec is
  itself a batched matmul.
* The modified GRU gate math matches grumod_step exactly: with
  v = iW x + b (precomputed) and u = sW h:
    z = sigmoid(v[:h] + u[:h]); r = sigmoid(v[h:2h] + u[h:2h])
    hbar = tanh(r * u[2h:] + v[2h:]);  h' = z h + (1-z) hbar
  (note: z first, r second, and r multiplies only the recurrent candidate).
* Global normalization subtracts the per-block mean log partition function of
  the flip-flop CRF (crf_manystay_partition_function, layers.c:1030-1076).

Weights: the reference's pretrained .mdl blobs are git-LFS pointers in this
mount, so `init_params` provides deterministic random weights with the
published shapes (conv winlen 19 stride 2, 256 filters, 256-unit GRUs,
supplementary section 2.6); `load_npz` loads converted real weights when
available.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

NBASE = 4
NSTATE = 8
NPARAM = NSTATE * (NBASE + 1)  # 40 transition weights per block


@dataclasses.dataclass(frozen=True)
class FlipflopConfig:
    winlen: int = 19
    stride: int = 2
    conv_filters: int = 256
    hidden: int = 256
    temperature: float = 1.0
    layer_dirs: tuple = ("b", "f", "b", "f", "b")  # networks.c:301-340


def init_params(cfg: FlipflopConfig, seed: int = 0) -> Dict[str, jnp.ndarray]:
    """Deterministic random weights with the production shapes."""
    k = jax.random.PRNGKey(seed)
    ks = jax.random.split(k, 4 + 3 * len(cfg.layer_dirs))
    h, nf = cfg.hidden, cfg.conv_filters
    p = {
        "conv_w": jax.random.normal(ks[0], (cfg.winlen, 1, nf)) * 0.3,
        "conv_b": jax.random.normal(ks[1], (nf,)) * 0.1,
        "ff_w": jax.random.normal(ks[2], (h, NPARAM)) * 0.2,
        "ff_b": jax.random.normal(ks[3], (NPARAM,)) * 0.05,
    }
    insize = nf
    for i in range(len(cfg.layer_dirs)):
        p[f"gru{i}_iw"] = jax.random.normal(
            ks[4 + 3 * i], (insize, 3 * h)) * (0.5 / np.sqrt(insize))
        p[f"gru{i}_b"] = jax.random.normal(ks[5 + 3 * i], (3 * h,)) * 0.05
        p[f"gru{i}_sw"] = jax.random.normal(
            ks[6 + 3 * i], (h, 3 * h)) * (0.5 / np.sqrt(h))
        insize = h
    return p


def load_npz(path: str) -> Dict[str, jnp.ndarray]:
    """Load converted weights (e.g. re-parsed from the guppy pickle via the
    format documented in flappie/misc/parse_flipflop_guppy.py)."""
    data = np.load(path)
    return {k: jnp.asarray(data[k]) for k in data.files}


def _flappie_conv_edge_plan(T: int, winlen: int, stride: int):
    """Columns where flappie's convolution differs from symmetric zero-pad.

    flappie's blocked right-edge bookkeeping (layers.c:235-256) can assign
    the final partial window to the wrong output column and leave the true
    last column bias-only (e.g. T=1000, winlen=7, stride=2: col 498 receives
    col 499's 5-tap window; col 499 = bias). Bit-parity with the reference
    basecaller requires reproducing this, so we simulate the reference's
    loop bookkeeping (left edge :202-209, blocked main :219-233, right edge
    :235-256) for the edge columns and return {col: [(tap, x_index), ...]}
    for every column whose coverage differs from the symmetric-pad conv.
    """
    padL = (winlen - 1) // 2
    padR = winlen // 2
    ncolC = -(-T // stride)
    nstepC = -(-winlen // stride)
    nstepX = stride * nstepC
    ncolsL = -(-padL // stride)
    shiftX_L = ncolsL * stride - padL
    cover = {}
    for w in range(0, padL, stride):  # left edge
        off = padL - w
        cover.setdefault(w // stride, []).extend(
            (k, k - off) for k in range(off, winlen))
    for w in range(0, winlen, stride):  # blocked main loop
        ncol_proc = (T - shiftX_L - w) // nstepX
        for j in range(ncol_proc):
            oc = ncolsL + w // stride + j * nstepC
            xoff = shiftX_L + w + j * nstepX
            if oc < ncolC:
                cover.setdefault(oc, []).extend(
                    (k, xoff + k) for k in range(winlen))
    maxCol = (T - shiftX_L) // nstepX
    rem = (T - shiftX_L) % nstepX
    offsetC_R = ncolsL + nstepC * (maxCol - 1) + rem // stride + 1
    offsetX_R = T - winlen + 1
    startR = stride - (padL + T - winlen) % stride - 1
    for w in range(startR, padR, stride):  # right edge
        oc = offsetC_R + w // stride
        if oc < ncolC:
            cover.setdefault(oc, []).extend(
                (k, offsetX_R + w + k) for k in range(winlen - (w + 1)))
    plan = {}
    for oc in range(ncolC):
        want = sorted((k, oc * stride + k - padL) for k in range(winlen)
                      if 0 <= oc * stride + k - padL < T)
        got = sorted(cover.get(oc, []))
        if got != want:
            plan[oc] = got
    return plan


def conv_same_stride(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray,
                     stride: int) -> jnp.ndarray:
    """1D conv matching flappie's convolution (layers.c:173-260).

    x: [B, T, insize]; w: [winlen, insize, nf]. Output column c covers input
    positions [c*stride - padL, ...]; padL = (winlen-1)//2, zero padding,
    out length ceil(T / stride) — except the reference's own edge quirks,
    reproduced exactly via _flappie_conv_edge_plan.
    """
    winlen = w.shape[0]
    pad_l = (winlen - 1) // 2
    pad_r = winlen // 2
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride,), padding=[(pad_l, pad_r)],
        dimension_numbers=("NHC", "HIO", "NHC"))
    for oc, pairs in _flappie_conv_edge_plan(x.shape[1], winlen,
                                             stride).items():
        val = jnp.zeros((x.shape[0], w.shape[2]), out.dtype)
        for k, i in pairs:
            val = val + x[:, i, :] @ w[k]
        out = out.at[:, oc, :].set(val)
    return out + b


def grumod_scan(xproj: jnp.ndarray, sw: jnp.ndarray,
                reverse: bool) -> jnp.ndarray:
    """Run the modified GRU over time. xproj: [T, 3h] (= iW x + b)."""
    h = sw.shape[0]

    def step(state, v):
        u = state @ sw  # [3h]
        z = jax.nn.sigmoid(v[:h] + u[:h])
        r = jax.nn.sigmoid(v[h:2 * h] + u[h:2 * h])
        hbar = jnp.tanh(r * u[2 * h:] + v[2 * h:])
        new = z * state + (1.0 - z) * hbar
        return new, new

    init = jnp.zeros((h,), xproj.dtype)
    _, out = jax.lax.scan(step, init, xproj, reverse=reverse)
    return out


def _partition_step(prev: jnp.ndarray, trans_blk: jnp.ndarray) -> jnp.ndarray:
    """One forward step of the flip-flop CRF in log space.

    trans_blk: [40] = rows [to0*8.., to1*8.., to2, to3, stay-from0..7].
    prev, out: [8] state log-mass.
    """
    t = trans_blk.reshape(NBASE + 1, NSTATE)
    flip = jax.nn.logsumexp(t[:NBASE] + prev[None, :], axis=1)  # [4]
    stay = prev[NBASE:] + t[NBASE, NBASE:]
    move = prev[:NBASE] + t[NBASE, :NBASE]
    flop = jnp.logaddexp(stay, move)
    return jnp.concatenate([flip, flop])


def crf_log_partition(trans: jnp.ndarray, nblk: jnp.ndarray) -> jnp.ndarray:
    """Log partition of the CRF over the (masked) sequence. trans: [T, 40]."""
    T = trans.shape[0]
    active = jnp.arange(T) < nblk

    def step(prev, xs):
        blk, act = xs
        new = _partition_step(prev, blk)
        new = jnp.where(act, new, prev)
        return new, ()

    init = jnp.zeros((NSTATE,), trans.dtype)
    out, _ = jax.lax.scan(step, init, (trans, active))
    return jax.nn.logsumexp(out)


def flipflop_transitions(params: Dict[str, jnp.ndarray], cfg: FlipflopConfig,
                         signal: jnp.ndarray,
                         nsamples: Optional[jnp.ndarray] = None
                         ) -> jnp.ndarray:
    """signal [B, T] (medmad-normalized) -> transition weights [B, T', 40].

    nsamples: per-read valid sample counts (padded reads); the CRF partition
    is computed over each read's own valid blocks.
    """
    B, T = signal.shape
    if nsamples is None:
        nsamples = jnp.full((B,), T, jnp.int32)
    x = conv_same_stride(signal[..., None], params["conv_w"],
                         params["conv_b"], cfg.stride)
    x = jnp.tanh(x)  # [B, T', nf]

    for i, d in enumerate(cfg.layer_dirs):
        xp = x @ params[f"gru{i}_iw"] + params[f"gru{i}_b"]
        x = jax.vmap(partial(grumod_scan, sw=params[f"gru{i}_sw"],
                             reverse=(d == "b")))(xp)

    raw = jnp.tanh(x @ params["ff_w"] + params["ff_b"])
    # shift_scale_matrix_inplace DIVIDES by temperature/5
    # (layers.c:1084, flappie_matrix.c:625-633): scale = 5/temperature
    scaled = raw * (5.0 / cfg.temperature)
    nblk = -(-nsamples // cfg.stride)
    logz = jax.vmap(crf_log_partition)(scaled, nblk) / nblk.astype(scaled.dtype)
    return scaled - logz[:, None, None]
