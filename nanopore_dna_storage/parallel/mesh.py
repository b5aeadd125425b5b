"""Multi-chip data-parallel decode driver.

The reference's scale-out story is processes + files: shard read-id lists,
run N independent jobs, merge list files afterwards
(util/extra/generate_read_id_files.py, merge_lists.py). Here the batch axis
is sharded over a ``jax.sharding.Mesh`` of chips; trellis tables ride along
replicated (they are jit constants), per-read decoding is embarrassingly
parallel, and the CRC/index classification + outcome counters run on device
so the cross-chip reduction is a single XLA collective (psum via sharded
``jnp.sum``) instead of the reference's merge scripts.

Works identically on one GPU, on the GPUs of one host, and on the 8-device
virtual CPU mesh used in tests (`--xla_force_host_platform_device_count=8`).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ConvCodeConfig, DecodeConfig, ExperimentConfig
from ..coding.crc import crc8_table
from ..ops import lva as lva_mod
from ..ops.lva import LVADecoder


def data_mesh(devices=None) -> jax.sharding.Mesh:
    devices = devices if devices is not None else jax.devices()
    return jax.sharding.Mesh(np.asarray(devices), ("data",))


def batch_sharding(mesh: jax.sharding.Mesh) -> jax.sharding.NamedSharding:
    return jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data"))


def replicated(mesh: jax.sharding.Mesh) -> jax.sharding.NamedSharding:
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())


def crc_index_classify(msgs: jnp.ndarray, valid: jnp.ndarray,
                       exp_index_len: int, exp_crc_len: int,
                       prp_a_inv: int, prp_b: int, num_oligos: int,
                       pad: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Device-side CRC8 + PRP index check (helper.py:371-388, vectorized).

    msgs: uint8 [B, L, msg_len] -> (ok [B, L] bool, index [B, L] int32).
    """
    table = jnp.asarray(crc8_table().astype(np.int32))
    bits = msgs[..., :-1] if pad else msgs
    nbits = bits.shape[-1]
    total = -(-nbits // 8) * 8
    lead = total - nbits
    padded = jnp.concatenate(
        [jnp.zeros(bits.shape[:-1] + (lead,), bits.dtype), bits], axis=-1)
    by = padded.reshape(padded.shape[:-1] + (total // 8, 8))
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
    as_bytes = (by.astype(jnp.int32) * weights).sum(-1)  # [B, L, nbytes]

    def crc_step(c, b):
        return table[c ^ b], ()

    nbytes = as_bytes.shape[-1]
    flat = as_bytes.reshape(-1, nbytes).T.astype(jnp.int32)  # [nbytes, BL]
    crc, _ = jax.lax.scan(crc_step, jnp.zeros(flat.shape[1], jnp.int32),
                          flat[:-1])
    ok = crc.reshape(msgs.shape[:-1]) == as_bytes[..., -1]
    iw = 2 ** jnp.arange(exp_index_len - 1, -1, -1, dtype=jnp.int32)
    scrambled = (bits[..., :exp_index_len].astype(jnp.int32) * iw).sum(-1)
    index = (prp_a_inv * (scrambled - prp_b)) % (1 << exp_index_len)
    ok = ok & (index < num_oligos) & valid
    return ok, index


@dataclasses.dataclass
class ShardedDecodeResult:
    msgs: np.ndarray  # [B, L, msg_len]
    scores: np.ndarray  # [B, L]
    ok: np.ndarray  # [B, L]
    index: np.ndarray  # [B, L]
    crc_pass_total: int  # reads with >= 1 passing candidate (global psum)


class ShardedDecoder:
    """LVA decode + classification over a data mesh, through the CONFIGURED
    backend.

    backend="traceback" (production) shards the batch through the chunk
    programs' shard_map (ops/lva_traceback.py); the CRC/index
    classification runs as a second jitted step over the same sharded
    batch, so per-shard counters still reduce with one psum.
    backend="oracle" keeps the single-jit message-carrying path; GSPMD
    shards the vmapped decode directly."""

    def __init__(self, exp: ExperimentConfig, list_size: int, rc: bool,
                 max_deviation: Optional[int] = 20,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 backend: str = "traceback", **kw):
        self.exp = exp
        self.mesh = mesh if mesh is not None else data_mesh()
        cfg = DecodeConfig(
            code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                                msg_len=exp.msg_len(), rc=rc),
            list_size=list_size, max_deviation=max_deviation,
            backend=backend, **kw)
        self.uses_traceback = backend == "traceback"
        self.inner = LVADecoder(cfg, mesh=self.mesh if self.uses_traceback
                                else None)
        spec = self.inner.spec
        f = exp.framing
        bsh = batch_sharding(self.mesh)
        rep = replicated(self.mesh)
        self._bsh = bsh

        def classify(bits, sc, valid, num_oligos):
            ok, index = crc_index_classify(
                bits, valid, f.index_len, f.crc_len, f.prp_a_inv, f.prp_b,
                num_oligos, exp.pad)
            crc_pass = ok.any(axis=1).sum()  # cross-shard psum by XLA
            return ok, index, crc_pass

        if self.uses_traceback:
            def traceback_classify(words, sc, okend, num_oligos):
                mwords = jax.lax.bitcast_convert_type(words, jnp.uint32)
                bits = _unpack_bits_device(spec, mwords)
                valid = (sc > -jnp.inf) & okend
                sc_v = jnp.where(valid, sc, -jnp.inf)
                ok, index, crc_pass = classify(bits, sc_v, valid,
                                               num_oligos)
                return bits, sc_v, ok, index, crc_pass

            self._classify = jax.jit(
                traceback_classify,
                in_shardings=(bsh, bsh, bsh),
                out_shardings=(bsh, bsh, bsh, bsh, rep),
                static_argnums=(3,))
        else:
            consts = lva_mod._consts(spec, self.inner.tables)

            def step(posts, starts, nblks, num_oligos):
                sc, m = jax.vmap(
                    partial(lva_mod._decode_single, spec, consts))(
                        posts, starts, nblks)
                valid = sc > -jnp.inf
                bits = _unpack_bits_device(spec, m)
                ok, index, crc_pass = classify(bits, sc, valid, num_oligos)
                return bits, sc, ok, index, crc_pass

            self._step = jax.jit(
                step,
                in_shardings=(bsh, bsh, bsh),
                out_shardings=(bsh, bsh, bsh, bsh, rep),
                static_argnums=(3,))

    def decode_global(self, posts, starts, nblks, num_oligos: int,
                      tlo=None, thi=None, active=None):
        """One global decode+classify step over committed (possibly
        multi-host global) arrays. For the traceback backend, the prep
        tables must be supplied (from ``TracebackDecoder.prep``,
        globalized by the caller); the oracle backend ignores them.
        Returns device arrays (bits, sc, ok, index, crc_pass)."""
        if not self.uses_traceback:
            return self._step(posts, starts, nblks, num_oligos)
        sc, words, okend = self.inner.traceback.decode_device(
            posts, starts, nblks, tlo, thi, active)
        return self._classify(words, sc, okend, num_oligos)

    def decode(self, posts: np.ndarray, nblks: np.ndarray,
               num_oligos: int) -> ShardedDecodeResult:
        B = posts.shape[0]
        ndev = len(self.mesh.devices.flat)
        if B % ndev:
            padb = ndev - B % ndev
            posts = np.concatenate(
                [posts, np.repeat(posts[-1:], padb, axis=0)])
            nblks = np.concatenate([nblks, np.repeat(nblks[-1:], padb)])
        starts = self.inner.schedule(nblks, posts.shape[1])
        put = partial(jax.device_put, device=self._bsh)
        if self.uses_traceback:
            posts, starts, nblks32, tlo, thi, active = \
                self.inner.traceback.prep(posts, starts, nblks)
            args = (put(posts), put(starts), put(nblks32), num_oligos,
                    put(tlo), put(thi), put(active))
        else:
            args = (put(np.asarray(posts, np.float32)),
                    put(np.asarray(starts, np.int32)),
                    put(np.asarray(nblks, np.int32)), num_oligos)
        bits, sc, ok, index, crc_pass = self.decode_global(*args)
        crc_from_pad = int(np.asarray(ok[B:]).any(axis=1).sum())
        return ShardedDecodeResult(
            msgs=np.asarray(bits[:B]), scores=np.asarray(sc[:B]),
            ok=np.asarray(ok[:B]), index=np.asarray(index[:B]),
            crc_pass_total=int(crc_pass) - crc_from_pad)


def _unpack_bits_device(spec, mwords: jnp.ndarray) -> jnp.ndarray:
    """uint32 words [..., M] -> uint8 bits [..., msg_len] on device."""
    code = spec.code
    msg_len, mem = code.config.msg_len, code.mem
    total = msg_len + mem
    i = np.arange(msg_len)
    bitpos = total - 1 - i
    if code.config.rc:
        bitpos = bitpos[::-1]
    words = jnp.asarray(bitpos // 32)
    shifts = jnp.asarray((bitpos % 32).astype(np.uint32))
    bits = (mwords[..., words] >> shifts) & jnp.uint32(1)
    return bits.astype(jnp.uint8)
