"""Formatted genome/sequence-database store.

Array-native replacement of the reference's formatted DB (.seq/.idx/.ent/.grp,
dbs.src:108-177 + makdbs): all contigs are concatenated into one flat int8
code array (memory-mappable .npy) with NIL sentinels between contigs, plus a
contig table (name, offset, length).  The flat array is what device kernels
slice windows out of; the contig table maps global coordinates back to
(chromosome, position) for reporting — the role of Block2Chr/CHROMO in the
reference block index (blksrc.h:194-236).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..constants import DNA, PROTEIN, UNKNOWN
from .fasta import iter_fasta


@dataclass
class GenomeStore:
    codes: np.ndarray          # int8, concatenated contigs with 1-NIL spacers
    names: list[str]
    offsets: np.ndarray        # int64 start of each contig in `codes`
    lengths: np.ndarray        # int64 length of each contig
    molc: int = DNA

    # ------------------------------------------------------------- building
    @classmethod
    def from_fasta(cls, path: str, molc: int = UNKNOWN) -> "GenomeStore":
        names, offs, lens, parts = [], [], [], []
        pos = 0
        m = molc
        for rec in iter_fasta(path, molc):
            m = rec.molc
            names.append(rec.name)
            offs.append(pos)
            lens.append(len(rec.codes))
            parts.append(rec.codes)
            parts.append(np.zeros(1, dtype=np.int8))     # NIL spacer
            pos += len(rec.codes) + 1
        codes = (np.concatenate(parts) if parts
                 else np.zeros(0, dtype=np.int8))
        return cls(codes=codes, names=names,
                   offsets=np.asarray(offs, dtype=np.int64),
                   lengths=np.asarray(lens, dtype=np.int64), molc=m)

    @classmethod
    def from_records(cls, records) -> "GenomeStore":
        names, offs, lens, parts = [], [], [], []
        pos = 0
        m = DNA
        for rec in records:
            m = rec.molc
            names.append(rec.name)
            offs.append(pos)
            lens.append(len(rec.codes))
            parts.append(np.asarray(rec.codes, dtype=np.int8))
            parts.append(np.zeros(1, dtype=np.int8))
            pos += len(rec.codes) + 1
        codes = (np.concatenate(parts) if parts
                 else np.zeros(0, dtype=np.int8))
        return cls(codes=codes, names=names,
                   offsets=np.asarray(offs, dtype=np.int64),
                   lengths=np.asarray(lens, dtype=np.int64), molc=m)

    # ------------------------------------------------------------ persistence
    def save(self, prefix: str) -> None:
        np.save(prefix + ".seq.npy", self.codes)
        np.save(prefix + ".ctg.npy",
                np.stack([self.offsets, self.lengths]))
        with open(prefix + ".meta.json", "w") as fh:
            json.dump({"names": self.names, "molc": self.molc,
                       "version": 1}, fh)

    @classmethod
    def load(cls, prefix: str, mmap: bool = True) -> "GenomeStore":
        codes = np.load(prefix + ".seq.npy",
                        mmap_mode="r" if mmap else None)
        ctg = np.load(prefix + ".ctg.npy")
        with open(prefix + ".meta.json") as fh:
            meta = json.load(fh)
        return cls(codes=codes, names=meta["names"], offsets=ctg[0],
                   lengths=ctg[1], molc=meta["molc"])

    # --------------------------------------------------------------- queries
    @property
    def total_len(self) -> int:
        return int(self.lengths.sum())

    @property
    def n_contigs(self) -> int:
        return len(self.names)

    def contig(self, idx_or_name) -> np.ndarray:
        i = (self.names.index(idx_or_name)
             if isinstance(idx_or_name, str) else idx_or_name)
        o = int(self.offsets[i])
        return np.asarray(self.codes[o:o + int(self.lengths[i])])

    def window(self, start: int, end: int) -> np.ndarray:
        """Slice [start, end) of the flat coordinate space (clamped)."""
        start = max(0, start)
        end = min(len(self.codes), end)
        return np.asarray(self.codes[start:end])

    def locate(self, gpos: int) -> tuple[int, int]:
        """Flat position -> (contig index, position within contig)."""
        i = int(np.searchsorted(self.offsets, gpos, side="right")) - 1
        i = max(i, 0)
        return i, gpos - int(self.offsets[i])

    def contig_bounds(self, i: int) -> tuple[int, int]:
        o = int(self.offsets[i])
        return o, o + int(self.lengths[i])
