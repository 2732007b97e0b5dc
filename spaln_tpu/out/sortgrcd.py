"""Locus merge / sort / filter — the sortgrcd equivalent.

The reference's accessory program (sortgrcd.cc, SURVEY.md A.8) merges the
binary outputs of many independent spaln runs, clusters transcripts into
gene loci (maximal same-chromosome same-strand overlap chains), filters by
quality, and re-sorts.  Here the unit is GeneStructure records — the merge
of many shards (multi-host runs) is list concatenation, so cluster/filter/
sort run identically on one shard or a pod's gathered results.

Sort key: (chromosome, strand, g_start, g_end, n_exons) = the reference's
(Csense, Gstart, Gend, nexn) compf.  A locus = maximal run of records whose
g_start <= running max g_end (findGeneEnd).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..align.gene import GeneStructure


_BIG = 1 << 30


@dataclass
class FilterParams:
    """Quality filters (FiltParam, sortgrcd.h:133-143; presets
    Filters[4], sortgrcd.cc:56-64 = {bmmc, bunp, ncan, Bmmc, Bunp, ng,
    Gscore, Pmatch, Pcover})."""
    bmmc: int = _BIG               # -m: per-terminal-exon boundary mmc
    bunp: int = _BIG               # -u: per-terminal-exon boundary unp
    ncan: int = 3                  # -n: terminal-junction canonicity
    Bmmc: int = _BIG               # per-gene boundary mismatch total
    Bunp: int = _BIG               # per-gene boundary unpaired total
    ng: int = _BIG                 # per-gene non-canonical introns
    min_score: float = -1e30       # Gscore (score/scale)
    min_identity: float = 0.0      # Pmatch (fraction)
    min_coverage: float = 0.0      # Pcover (fraction)
    # retained extras
    max_bad_junctions: int = _BIG  # alias of ng (legacy callers)

    @classmethod
    def preset(cls, level: int) -> "FilterParams":
        if level <= 0:
            return cls()
        if level == 1:
            return cls(bmmc=5, bunp=3, ncan=2, Bmmc=10, Bunp=6, ng=3,
                       min_score=35., min_identity=.75, min_coverage=.75)
        if level == 2:
            return cls(bmmc=3, bunp=2, ncan=1, Bmmc=6, Bunp=4, ng=2,
                       min_score=35., min_identity=.93, min_coverage=.93)
        return cls(bmmc=1, bunp=1, ncan=0, Bmmc=2, Bunp=2, ng=1,
                   min_score=35., min_identity=.97, min_coverage=.97)


@dataclass
class Locus:
    chrom: str
    strand: str
    g_start: int
    g_end: int
    members: list[GeneStructure] = field(default_factory=list)


def passes(gs: GeneStructure, q_len: int, fp: FilterParams) -> bool:
    """Per-gene filter (sortgrcd.cc:233-235)."""
    if gs.identity < fp.min_identity:
        return False
    if q_len and gs.coverage(q_len) < fp.min_coverage:
        return False
    if gs.score / gs.scale < fp.min_score:
        return False
    bad = sum(1 for i in gs.introns if not i.canonical)
    if bad > min(fp.ng, fp.max_bad_junctions):
        return False
    if sum(e.bmmc for e in gs.exons) > fp.Bmmc:
        return False
    return sum(e.bunp for e in gs.exons) <= fp.Bunp


def trim_terminal_exons(gs: GeneStructure, fp: FilterParams) -> None:
    """Drop low-confidence terminal exons (sortgrcd.cc:248-268): the
    first exon (when >1) goes if its junction is non-canonical under
    ncan<3 or its boundary windows exceed -m/-u; likewise the last
    exon (when >2 exons)."""
    def bad_first():
        if len(gs.exons) < 2:
            return False
        e = gs.exons[0]
        if fp.ncan < 3 and gs.introns and not gs.introns[0].canonical:
            return True
        return e.bmmc > fp.bmmc or e.bunp > fp.bunp

    def bad_last():
        if len(gs.exons) < 3:
            return False
        e = gs.exons[-1]
        if fp.ncan < 3 and gs.introns and not gs.introns[-1].canonical:
            return True
        return e.bmmc > fp.bmmc or e.bunp > fp.bunp

    while bad_first():
        gs.exons.pop(0)
        gs.introns.pop(0)
    while bad_last():
        gs.exons.pop()
        gs.introns.pop()


def _chrom_order(records: list[GeneStructure], order: str,
                 appearance: list | None = None) -> dict:
    """Chromosome rank for -S a|b|c (sortgrcd.cc:42, 66-67)."""
    chroms = []
    for g in records:
        if g.g_name not in chroms:
            chroms.append(g.g_name)
    if order == "b":                      # abundance (record count desc)
        from collections import Counter
        cnt = Counter(g.g_name for g in records)
        chroms.sort(key=lambda c: (-cnt[c], c))
    elif order == "c" and appearance:     # genome appearance
        rank = {c: i for i, c in enumerate(appearance)}
        chroms.sort(key=lambda c: rank.get(c, len(rank)))
    else:                                 # "a"/"r": alphabetic
        chroms.sort()
    return {c: i for i, c in enumerate(chroms)}


def sort_records(records: list[GeneStructure], order: str = "a",
                 appearance: list | None = None
                 ) -> list[GeneStructure]:
    """(chrom, strand, g_start, g_end, n_exons) ordering (compf), with
    -S a|b|c|r chromosome orders; 'r' lists minus-strand genes in
    descending genomic position (reverse-minus)."""
    rank = _chrom_order(records, order, appearance)

    def key(g):
        g0, g1 = g.g_span
        if order == "r" and g.strand == "-":
            return (rank[g.g_name], 1, -g1, -g0, len(g.exons))
        return (rank[g.g_name], 0 if g.strand == "+" else 1, g0, g1,
                len(g.exons))

    return sorted(records, key=key)


def cluster_loci(records: list[GeneStructure],
                 q_lens: dict | None = None,
                 filt: FilterParams | None = None) -> list[Locus]:
    """Merge (possibly multi-shard) records into gene loci."""
    filt = filt or FilterParams()
    kept = []
    for g in records:
        if not passes(g, (q_lens or {}).get(g.q_name, 0), filt):
            continue
        trim_terminal_exons(g, filt)
        kept.append(g)
    out: list[Locus] = []
    cur: Locus | None = None
    for g in sort_records(kept):
        g0, g1 = g.g_span
        if (cur is not None and g.g_name == cur.chrom
                and g.strand == cur.strand and g0 <= cur.g_end):
            cur.members.append(g)
            cur.g_end = max(cur.g_end, g1)
        else:
            cur = Locus(chrom=g.g_name, strand=g.strand, g_start=g0,
                        g_end=g1, members=[g])
            out.append(cur)
    return out


def unique_introns(records: list[GeneStructure]) -> list[tuple]:
    """Distinct introns across all records (-O15 role): keyed by
    (chrom, strand, start, end) with support counts."""
    seen: dict[tuple, int] = {}
    for g in records:
        for i in g.introns:
            key = (g.g_name, g.strand, i.g_start, i.g_end)
            seen[key] = seen.get(key, 0) + 1
    return sorted((k + (v,)) for k, v in seen.items())


def locus_report(loci: list[Locus]) -> list[str]:
    """Text report: '!' locus header + '@' member transcripts
    (README.md:455-459 delimiters)."""
    lines = []
    for lo in loci:
        lines.append(f"!\t{lo.chrom}\t{lo.strand}\t{lo.g_start + 1}\t"
                     f"{lo.g_end}\t{len(lo.members)}")
        for g in lo.members:
            lines.append(f"@\t{g.q_name}\t{g.g_span[0] + 1}\t{g.g_span[1]}"
                         f"\t{g.score / g.scale:.1f}\t{len(g.exons)}"
                         f"\t{g.identity * 100:.1f}")
    return lines


# ---------------------------------------------------------------- O12 binary
# The reference's -O12 writes GeneRecord/ExonRecord/name triples
# (.grd/.erd/.qrd, seq.h:1212-1255) that sortgrcd merges across runs.
# Equivalent here: one compressed npz shard per run with columnar
# gene/exon tables — append-only result shards + a merge step
# (SURVEY.md section 5 checkpoint stance).

def write_grd(path: str, records: list[GeneStructure],
              q_lens: dict | None = None) -> None:
    import numpy as np
    names: list[str] = []
    chroms: list[str] = []
    gene_rows = []
    exon_rows = []
    intr_rows = []
    for g in records:
        qi = len(names)
        names.append(g.q_name)
        ci = chroms.index(g.g_name) if g.g_name in chroms else len(chroms)
        if ci == len(chroms):
            chroms.append(g.g_name)
        g0, g1 = g.g_span
        gene_rows.append((qi, ci, 1 if g.strand == "+" else -1, g.score,
                          g0, g1, len(g.exons), len(exon_rows),
                          len(intr_rows),
                          (q_lens or {}).get(g.q_name, 0)))
        for e in g.exons:
            exon_rows.append((e.q_start, e.q_end, e.g_start, e.g_end,
                              e.mch, e.mmc, e.gap, e.unp, e.sig5, e.sig3,
                              e.bmmc, e.bunp))
        for i in g.introns:
            intr_rows.append((i.g_start, i.g_end, i.q_pos, i.sig5, i.sig3,
                              1 if i.canonical else 0))
    np.savez_compressed(
        path,
        genes=np.array(gene_rows, dtype=np.int64).reshape(-1, 10),
        exons=np.array(exon_rows, dtype=np.int64).reshape(-1, 12),
        introns=np.array(intr_rows, dtype=np.int64).reshape(-1, 6),
        names=np.array(names), chroms=np.array(chroms))


def read_grd(path: str) -> tuple[list[GeneStructure], dict]:
    import numpy as np
    from ..align.gene import Exon, Intron
    z = np.load(path, allow_pickle=False)
    names = [str(x) for x in z["names"]]
    chroms = [str(x) for x in z["chroms"]]
    genes, exons, introns = z["genes"], z["exons"], z["introns"]
    out: list[GeneStructure] = []
    q_lens: dict[str, int] = {}
    for gi, row in enumerate(genes):
        (qi, ci, sense, score, g0, g1, nexn, eoff, ioff, qlen) = row
        nintr = nexn - 1
        # back-compat: 10-column shards predate the bmmc/bunp columns
        exs = [Exon(*map(int, exons[eoff + k][:12])) for k in range(nexn)]
        ins = []
        for k in range(nintr):
            s0, s1, qp, s5, s3, can = map(int, introns[ioff + k])
            ins.append(Intron(g_start=s0, g_end=s1, q_pos=qp, sig5=s5,
                              sig3=s3, canonical=bool(can)))
        gs = GeneStructure(score=int(score), exons=exs, introns=ins,
                           q_name=names[qi], g_name=chroms[ci],
                           strand="+" if sense > 0 else "-")
        out.append(gs)
        if qlen:
            q_lens[names[qi]] = int(qlen)
    return out, q_lens


def merge_grd(paths: list[str]) -> tuple[list[GeneStructure], dict]:
    """Merge many run shards (the sortgrcd multi-run entry)."""
    records: list[GeneStructure] = []
    q_lens: dict[str, int] = {}
    for p in paths:
        recs, ql = read_grd(p)
        records.extend(recs)
        q_lens.update(ql)
    return records, q_lens
