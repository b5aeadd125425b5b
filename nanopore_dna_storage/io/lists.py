"""Decoded-list output files in the reference's on-disk format.

generate_decoded_lists.py:47,85-98 writes one ``list_<i>`` file per read (one
decoded bit string per line) plus an ``info.txt`` with per-read status lines;
util/extra/merge_lists.py merges shards and pick_new_reads.py computes resume
sets. We reproduce the format for drop-in evaluation-script compatibility and
add an append-only manifest for shard resume.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


def write_list_file(outdir: str, index: int, msgs: Sequence[str]) -> None:
    path = pathlib.Path(outdir) / f"list_{index}"
    with open(path, "w") as f:
        for m in msgs:
            f.write(m + "\n")


def read_list_file(outdir: str, index: int, max_list: Optional[int] = None
                   ) -> List[str]:
    path = pathlib.Path(outdir) / f"list_{index}"
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f]
    return lines[:max_list] if max_list else lines


def write_info(outdir: str, lines: Iterable[str]) -> None:
    with open(pathlib.Path(outdir) / "info.txt", "w") as f:
        for l in lines:
            f.write(l + "\n")


def decoded_indices(outdir: str) -> List[int]:
    """Indices with an existing list file (the resume set complement,
    cf. util/extra/pick_new_reads.py:12-18)."""
    out = []
    for p in pathlib.Path(outdir).glob("list_*"):
        try:
            out.append(int(p.name.split("_", 1)[1]))
        except ValueError:
            continue
    return sorted(out)


def merge_shards(shard_dirs: Sequence[str], outdir: str) -> int:
    """Merge per-shard list_*/info outputs into one directory with
    sequential indices (util/extra/merge_lists.py:11-21). Returns count."""
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    info_lines: List[str] = []
    n = 0
    for shard in shard_dirs:
        ids = decoded_indices(shard)
        info_path = pathlib.Path(shard) / "info.txt"
        shard_info = (info_path.read_text().splitlines()
                      if info_path.exists() else [])
        for i in ids:
            msgs = read_list_file(shard, i)
            write_list_file(str(out), n, msgs)
            if i < len(shard_info):
                info_lines.append(shard_info[i])
            n += 1
    write_info(str(out), info_lines)
    return n


class ShardManifest:
    """Append-only per-shard progress record (jsonl), the device-side
    equivalent of the reference's file-per-read resume granularity."""

    def __init__(self, path: str):
        self.path = pathlib.Path(path)

    def done_ids(self) -> set:
        if not self.path.exists():
            return set()
        out = set()
        with open(self.path) as f:
            for line in f:
                try:
                    out.add(json.loads(line)["read"])
                except (json.JSONDecodeError, KeyError):
                    continue
        return out

    def record(self, read_id: str, **extra) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"read": read_id, **extra}) + "\n")
