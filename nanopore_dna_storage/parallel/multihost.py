"""Multi-host (N-process) scale-out for the decode pipeline.

The reference scales across machines by sharding read-id files, launching N
independent decode jobs and merging their ``list_<i>``/``info_*`` outputs
afterwards (util/extra/generate_read_id_files.py:10-37,
util/extra/merge_lists.py:11-21). Here the same read-data parallelism runs as
ONE global program: ``jax.distributed`` connects the hosts, every host feeds
its process-local slice of the read batch into a batch-sharded global array,
the jitted decode+classify step runs on the global mesh, and cross-host
reduction of outcome counters is a single XLA collective (the ``psum`` that
replaces the merge scripts). Per-read outputs land back on the host that fed
them (addressable shards), so each host writes only its own ``list_<i>``
files — the reference's per-shard output model, without a merge step for the
statistics.

Launch (one command per host, or use scripts/launch_multihost.py locally):

    python -m nanopore_dna_storage.parallel.multihost \
        --coordinator HOST0:1234 --num-processes N --process-id I \
        --post-dir DIR --outdir OUT --experiment 7 --list-size 8
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

import jax

from ..config import ExperimentConfig


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``jax.distributed.initialize`` with env-var fallbacks.

    Pass coordinator (host:port), world size and rank explicitly (or set
    NDS_COORDINATOR / NDS_NUM_PROCESSES / NDS_PROCESS_ID).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "NDS_COORDINATOR")
    if num_processes is None and "NDS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NDS_NUM_PROCESSES"])
    if process_id is None and "NDS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["NDS_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


class MultiHostDecoder:
    """Batch-sharded LVA decode + CRC classify over a global device mesh.

    Wraps :class:`..parallel.mesh.ShardedDecoder` (which dispatches through
    the configured backend) with
    process-local feeding: each host supplies ``local_batch`` reads per
    step; the global batch (num_processes * local_batch) is assembled with
    ``jax.make_array_from_process_local_data`` so no host ever
    materializes another host's posts. With ``auto_orientation`` every
    batch decodes in BOTH orientations and each read keeps the one with
    the higher top path score — the reference's fwd/RC handling
    (generate_decoded_lists.py:68-74) without the barcode artifacts.
    """

    def __init__(self, exp: ExperimentConfig, list_size: int,
                 rc: bool = False, max_deviation: Optional[int] = 20,
                 auto_orientation: bool = False, backend: str = "traceback",
                 **kw):
        from .mesh import ShardedDecoder, batch_sharding, data_mesh

        self.mesh = data_mesh(jax.devices())  # global: all hosts' devices
        mk = lambda flag: ShardedDecoder(  # noqa: E731
            exp, list_size, flag, max_deviation=max_deviation,
            mesh=self.mesh, backend=backend, **kw)
        self.sharded = mk(rc)
        self.sharded_rc = mk(not rc) if auto_orientation else None
        self._bsh = batch_sharding(self.mesh)
        self.num_processes = jax.process_count()
        self.process_id = jax.process_index()

    def _globalize(self, local: np.ndarray) -> jax.Array:
        gshape = (local.shape[0] * self.num_processes,) + local.shape[1:]
        return jax.make_array_from_process_local_data(
            self._bsh, local, gshape)

    def _decode_one(self, dec, posts: np.ndarray, nblks: np.ndarray,
                    num_oligos: int):
        """One global decode+classify step through ``dec``; local results."""
        starts = dec.inner.schedule(nblks, posts.shape[1])
        g = self._globalize
        if dec.uses_traceback:
            p, s, nb, tlo, thi, act = dec.inner.traceback.prep(
                posts, starts, nblks)
            args = (g(p), g(s), g(nb), num_oligos, g(tlo), g(thi), g(act))
        else:
            args = (g(np.asarray(posts, np.float32)),
                    g(np.asarray(starts, np.int32)),
                    g(np.asarray(nblks, np.int32)), num_oligos)
        bits, sc, ok, index, _ = dec.decode_global(*args)

        def local_np(garr):
            shards = sorted(garr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            return np.concatenate([np.asarray(s.data) for s in shards])

        return local_np(bits), local_np(sc), local_np(ok), local_np(index)

    def decode_local(self, posts: np.ndarray, nblks: np.ndarray,
                     num_oligos: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray,
                                               np.ndarray]:
        """Decode this host's reads as part of one global step.

        posts [B_local, T, 5, 8]; B_local must be a multiple of the local
        device count and identical across hosts (pad the tail batch).
        Returns (msgs, scores, ok, index, rc_used) for the local reads.
        """
        ndev_local = len(jax.local_devices())
        B = posts.shape[0]
        if B % ndev_local:
            raise ValueError(f"local batch {B} not a multiple of local "
                             f"device count {ndev_local}")
        bits, sc, ok, index = self._decode_one(self.sharded, posts, nblks,
                                               num_oligos)
        rc_used = np.zeros(B, bool)
        if self.sharded_rc is not None:
            bits_r, sc_r, ok_r, index_r = self._decode_one(
                self.sharded_rc, posts, nblks, num_oligos)
            # per read, keep the orientation with the higher top path
            # score (lists are score-sorted; tie -> first orientation)
            rc_used = sc_r[:, 0] > sc[:, 0]
            pick = lambda a, b: np.where(  # noqa: E731
                rc_used.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
            bits, sc = pick(bits_r, bits), pick(sc_r, sc)
            ok, index = pick(ok_r, ok), pick(index_r, index)
        return bits, sc, ok, index, rc_used


def run_decode_job(post_dir: str, outdir: str, exp: ExperimentConfig,
                   list_size: int, max_deviation: int = 20,
                   local_batch: int = 8, backend: str = "traceback",
                   auto_orientation="gated") -> int:
    """Decode every ``.post`` in ``post_dir``, sharded over hosts by stride.

    Host i takes posts i, i+N, i+2N, ... (the reference's read-id sharding,
    generate_read_id_files.py) and writes its ``list_<idx>`` files plus an
    ``info_<i>.txt`` shard manifest into ``outdir`` — which then looks
    exactly like the merged output of merge_lists.py.

    ``auto_orientation``: "gated" (default) decodes everything forward,
    then runs a SECOND phase re-decoding only the reads with no
    CRC-passing candidate in RC — job cost (1 + fail_fraction)x one
    orientation instead of the 2x of "both" (the reference decodes each
    read once, orientation pre-picked from the barcode,
    generate_decoded_lists.py:68-82; the CRC check is the analogous
    oracle when no basecall exists). "both" decodes every read in both
    orientations and keeps the higher top score; False decodes forward
    only. Returns the global crc-pass count.
    """
    import glob

    from ..io.lists import write_list_file
    from ..io.post import read_post, pack_posts

    from jax.experimental import multihost_utils

    pid = jax.process_index()
    nproc = jax.process_count()
    post_files = sorted(glob.glob(os.path.join(post_dir, "*.post")))
    mine = post_files[pid::nproc]
    # equal step counts on every host: pad the global count so all hosts run
    # the same number of collective steps
    per_host = -(-len(post_files) // nproc)
    os.makedirs(outdir, exist_ok=True)

    gated = auto_orientation == "gated"
    dec = MultiHostDecoder(exp, list_size, rc=False,
                           max_deviation=max_deviation, backend=backend,
                           auto_orientation=bool(auto_orientation))
    ndev_local = len(jax.local_devices())
    local_batch = max(ndev_local, (local_batch // ndev_local) * ndev_local)
    num_oligos = 1 << exp.framing.index_len
    min_blk = dec.sharded.inner.spec.code.nstate_pos + 1

    def batch_arrays(files, nsteps_pad=None):
        posts = [read_post(f) for f in files]
        npad = local_batch - len(posts)
        if posts:
            packed, nblks = pack_posts(posts)
        else:
            packed = np.zeros((0, 128, 5, 8), np.float32)
            nblks = np.zeros((0,), np.int64)
        if npad:
            ghost_T = packed.shape[1] if len(posts) else 128
            ghost = np.zeros((npad, ghost_T, 5, 8), np.float32)
            packed = np.concatenate([packed, ghost]) if len(posts) else ghost
            nblks = np.concatenate(
                [nblks, np.full(npad, max(min_blk, ghost_T), np.int64)])
        return packed, nblks

    results = {}  # file -> [msgs, sc, ok, index, rc_used]
    total_steps = -(-per_host // local_batch)
    for lo in range(0, total_steps * local_batch, local_batch):
        batch_files = mine[lo: lo + local_batch]
        packed, nblks = batch_arrays(batch_files)
        if gated:
            msgs, sc, ok, index = dec._decode_one(dec.sharded, packed,
                                                  nblks, num_oligos)
            rc_used = np.zeros(len(packed), bool)
        else:
            msgs, sc, ok, index, rc_used = dec.decode_local(
                packed, nblks, num_oligos)
        for j, f in enumerate(batch_files):
            results[f] = [msgs[j], sc[j], ok[j], index[j], rc_used[j]]

    if gated:
        # phase 2: re-decode ONLY this host's CRC-failed reads in RC; all
        # hosts run the max step count (ghost batches keep the collective
        # program uniform)
        need = [f for f in mine if not results[f][2].any()]
        nsteps = int(multihost_utils.process_allgather(np.asarray(
            [-(-len(need) // local_batch)])).max())
        for step in range(nsteps):
            batch_files = need[step * local_batch:
                               (step + 1) * local_batch]
            packed, nblks = batch_arrays(batch_files)
            msgs, sc, ok, index = dec._decode_one(
                dec.sharded_rc, packed, nblks, num_oligos)
            for j, f in enumerate(batch_files):
                r = results[f]
                # RC wins where it CRC-passes, or neither passes and RC's
                # top path score is higher (tie -> fwd)
                if ok[j].any() or sc[j, 0] > r[1][0]:
                    results[f] = [msgs[j], sc[j], ok[j], index[j], True]

    total_crc = 0
    info_lines = []
    for lo, f in enumerate(mine):
        msgs, sc, ok, index, rc_used = results[f]
        total_crc += int(ok.any())
        stem = os.path.basename(f)[: -len(".post")]
        idx = int(stem.split("_")[-1]) if stem.split("_")[-1].isdigit() \
            else lo
        lst = ["".join(map(str, m))
               for m, v in zip(msgs, sc > -np.inf) if v]
        write_list_file(outdir, idx, lst[:list_size])
        info_lines.append(f"{stem} rc={bool(rc_used)}")
    # per-host info shard (the reference's info_<i> files, merge_lists.py)
    with open(os.path.join(outdir, f"info_{pid}.txt"), "w") as f:
        f.write("".join(ln + "\n" for ln in info_lines))

    return int(multihost_utils.process_allgather(
        np.asarray([total_crc])).sum())


def main(argv=None):
    import argparse

    from ..pipeline.experiments import experiment

    ap = argparse.ArgumentParser(prog="nds-multihost")
    ap.add_argument("--coordinator", required=False)
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--post-dir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--experiment", type=int, default=7,
                    help="published experiment id 0..12; < 0 = custom via "
                         "--bytes-per-oligo/--mem/--rate")
    ap.add_argument("--bytes-per-oligo", type=int, default=18)
    ap.add_argument("--mem", type=int, default=11)
    ap.add_argument("--rate", type=int, default=5)
    ap.add_argument("--rs-redundancy", type=float, default=0.3)
    ap.add_argument("--pad", action="store_true")
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--max-deviation", type=int, default=20)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--backend", default="traceback",
                    choices=["traceback", "oracle"],
                    help="traceback = production path (sharded via "
                         "shard_map); oracle = message-carrying path")
    ap.add_argument("--orientation", default="gated",
                    choices=["gated", "both", "fwd"],
                    help="gated = decode fwd, re-decode CRC failures in RC "
                         "(default); both = decode every read both ways; "
                         "fwd = forward only")
    ap.add_argument("--no-auto-orientation", dest="orientation",
                    action="store_const", const="fwd",
                    help="alias for --orientation fwd")
    args = ap.parse_args(argv)
    if os.environ.get("NDS_FORCE_CPU"):
        # CPU rehearsal of a multi-host job (scripts/launch_multihost.py)
        jax.config.update("jax_platforms", "cpu")
    initialize(args.coordinator, args.num_processes, args.process_id)
    if args.experiment >= 0:
        exp = experiment(args.experiment)
    else:
        exp = ExperimentConfig(
            bytes_per_oligo=args.bytes_per_oligo,
            rs_redundancy=args.rs_redundancy,
            conv_mem=args.mem, conv_rate=args.rate, pad=args.pad)
    crc = run_decode_job(args.post_dir, args.outdir, exp, args.list_size,
                         args.max_deviation, args.local_batch,
                         backend=args.backend,
                         auto_orientation={"gated": "gated", "both": True,
                                           "fwd": False}[args.orientation])
    print(f"process {jax.process_index()}/{jax.process_count()} done; "
          f"global crc_pass={crc}")


if __name__ == "__main__":
    main()
