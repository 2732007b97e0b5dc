#!/usr/bin/env python3
"""Synthetic genome with planted multi-exon genes, plus query streams and
their truth, all made from one seed.

The full size follows Dictyostelium discoideum, whose clade tables
(``-T Dictyost``) are vendored in data_tables/: six chromosomes of about
34 Mb in all, AT-rich.  Genes have 2-8 exons of 50-400 nt, canonical
GT..AG introns of 60 nt to a few kb (log-uniform), and sit on both
strands; a few genes have a diverged paralog copy elsewhere.  Each gene
is a coding sequence (ATG .. stop, no in-frame stop) split into exons,
so a query can be its spliced transcript or its translation.

    python scripts/synth_genes.py OUTDIR [--seed 0] [--tiny]

writes OUTDIR/genome.fa, OUTDIR/cdna.fa, OUTDIR/protein.fa and
OUTDIR/truth.json.  Truth coordinates are 0-based, half-open, on the
forward strand of the named chromosome; a gene's exons and introns are
listed in ascending genome order.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
AAS = "ACDEFGHIKLMNPQRSTVWY"
# standard genetic code, codons in TCAG order
_CODE = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRR"
         "VVVVAAAADDEEGGGG")
CODON_AA = {a + b + c: _CODE[16 * i + 4 * j + k]
            for i, a in enumerate("TCAG") for j, b in enumerate("TCAG")
            for k, c in enumerate("TCAG")}
SYNONYMS = {aa: [c for c, x in sorted(CODON_AA.items()) if x == aa]
            for aa in AAS}
STOPS = [c for c, x in sorted(CODON_AA.items()) if x == "*"]


@dataclass(frozen=True)
class Spec:
    chroms: tuple            # (name, length) per chromosome
    n_genes: int
    n_cdna: int
    n_protein: int
    n_paralogs: int
    cds_len: tuple           # (min, max) nt of a query transcript
    exon_len: tuple = (50, 400)
    n_exons: tuple = (2, 8)
    intron_len: tuple = (60, 3000)
    gc: float = 0.30         # background GC fraction (AT-rich genome)
    sub_rate: float = 0.01   # cDNA substitutions
    paralog_div: float = 0.10
    spacing: int = 30_000    # least distance between planted genes


# D. discoideum AX4 chromosome sizes, rounded to 0.1 Mb (dictyBase)
FULL = Spec(chroms=(("chr1", 4_900_000), ("chr2", 8_500_000),
                    ("chr3", 6_400_000), ("chr4", 5_400_000),
                    ("chr5", 5_100_000), ("chr6", 3_600_000)),
            n_genes=150, n_cdna=64, n_protein=16, n_paralogs=4,
            cds_len=(300, 3000))
TINY = Spec(chroms=(("chrA", 150_000), ("chrB", 100_000)),
            n_genes=12, n_cdna=6, n_protein=3, n_paralogs=1,
            cds_len=(150, 420), exon_len=(50, 200), n_exons=(2, 3),
            intron_len=(60, 400), spacing=4_000)


def revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]


def translate_cds(cds: str) -> str:
    return "".join(CODON_AA[cds[i:i + 3]] for i in range(0, len(cds) - 2, 3))


def _random_dna(rng, n: int, gc: float) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return BASES[rng.choice(4, size=n, p=p)]


def _cds(rng, n_codons: int) -> str:
    """ATG + random sense codons + stop: no in-frame stop codon."""
    aa = rng.choice(list(AAS), n_codons - 2)
    body = "".join(SYNONYMS[a][rng.integers(len(SYNONYMS[a]))]
                   for a in aa)
    return "ATG" + body + STOPS[rng.integers(len(STOPS))]


def _split(rng, cds: str, spec: Spec):
    """Exon lengths summing to len(cds) within spec, cut where neither
    side of the junction is a G (so no junction can slide along the
    cDNA: a shift needs exon bases equal to the GT/AG intron ends)."""
    n = len(cds)
    for _ in range(1000):
        k = int(rng.integers(spec.n_exons[0], spec.n_exons[1] + 1))
        if not spec.exon_len[0] * k <= n <= spec.exon_len[1] * k:
            continue
        cuts, pos = [], 0
        ok = True
        for i in range(k - 1):
            rest = k - 1 - i
            lo = max(pos + spec.exon_len[0], n - rest * spec.exon_len[1])
            hi = min(pos + spec.exon_len[1], n - rest * spec.exon_len[0])
            cand = [c for c in range(lo, hi + 1)
                    if cds[c - 1] != "G" and cds[c] != "G"]
            if not cand:
                ok = False
                break
            pos = int(cand[rng.integers(len(cand))])
            cuts.append(pos)
        if ok:
            bounds = [0] + cuts + [n]
            return [cds[a:b] for a, b in zip(bounds, bounds[1:])]
    raise RuntimeError("no exon split found")


def _intron(rng, spec: Spec) -> str:
    lo, hi = spec.intron_len
    n = int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
    core = _random_dna(rng, n - 14, 0.2).tobytes().decode()
    ppt = "".join(rng.choice(list("TTTC"), 6))
    return "GTAAGT" + core + ppt + "AG"


def _mutate(rng, s: str, rate: float, keep=()) -> str:
    """Substitute a fraction ``rate`` of positions, sparing ``keep``."""
    b = bytearray(s.encode())
    hit = np.flatnonzero(rng.random(len(b)) < rate)
    for p in hit:
        if any(a <= p < e for a, e in keep):
            continue
        b[p] = ord("ACGT"[(("ACGT".index(chr(b[p])))
                           + int(rng.integers(1, 4))) % 4])
    return b.decode()


def make_dataset(outdir: str, seed: int = 0, spec: Spec = FULL) -> dict:
    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    chroms = {name: _random_dna(rng, n, spec.gc) for name, n in spec.chroms}
    names = [c for c, _ in spec.chroms]
    weights = np.array([n for _, n in spec.chroms], float)
    weights /= weights.sum()
    taken: dict[str, list] = {c: [] for c in names}
    gap = spec.spacing

    def place(span: int):
        for _ in range(10_000):
            c = names[rng.choice(len(names), p=weights)]
            n = len(chroms[c])
            s = int(rng.integers(gap, n - span - gap))
            if all(s + span + gap <= a or s >= b + gap
                   for a, b in taken[c]):
                taken[c].append((s, s + span))
                return c, s
        raise RuntimeError("genome too small for the planted genes")

    genes = []
    for gi in range(spec.n_genes + spec.n_paralogs):
        if gi < spec.n_genes:
            lo, hi = spec.cds_len
            cds = _cds(rng, int(rng.integers(lo // 3, hi // 3 + 1)))
            exons = _split(rng, cds, spec)
            introns = [_intron(rng, spec) for _ in exons[1:]]
            name = f"g{gi:03d}"
            parent = None
        else:                       # diverged copy of an earlier gene
            src = genes[int(rng.integers(spec.n_genes))]
            parent = src["name"]
            name = f"{parent}p"
            exons = [_mutate(rng, e, spec.paralog_div)
                     for e in src["_exons"]]
            introns = [_mutate(rng, i, spec.paralog_div,
                               keep=((0, 6), (len(i) - 8, len(i))))
                       for i in src["_introns"]]
        parts = [exons[0]]
        for e, i in zip(exons[1:], introns):
            parts += [i, e]
        gene = "".join(parts)
        strand = "+" if rng.random() < 0.5 else "-"
        c, s = place(len(gene))
        seq = gene if strand == "+" else revcomp(gene)
        chroms[c][s:s + len(seq)] = np.frombuffer(seq.encode(), np.uint8)
        # transcript-order spans -> forward-genome coordinates
        spans, o = [], 0
        for p in parts:
            spans.append((o, o + len(p)))
            o += len(p)
        if strand == "-":
            spans = [(len(gene) - b, len(gene) - a) for a, b in spans][::-1]
        spans = [(s + a, s + b) for a, b in spans]
        genes.append(dict(
            name=name, chrom=c, strand=strand, start=s, end=s + len(gene),
            exons=[list(x) for x in spans[0::2]],
            introns=[list(x) for x in spans[1::2]],
            paralog_of=parent, cds="".join(exons),
            protein=translate_cds("".join(exons))[:-1],
            _exons=exons, _introns=introns))

    order = rng.permutation(spec.n_genes)
    cdna_genes = [genes[i] for i in order[:spec.n_cdna]]
    prot_genes = [genes[i] for i in
                  order[spec.n_cdna:spec.n_cdna + spec.n_protein]]
    with open(os.path.join(outdir, "genome.fa"), "wb") as f:
        for c in names:
            f.write(f">{c}\n".encode())
            a = chroms[c]
            w = 80
            full = len(a) // w * w
            rows = np.concatenate([a[:full].reshape(-1, w),
                                   np.full((full // w, 1), 10, np.uint8)],
                                  axis=1)
            f.write(rows.tobytes())
            if full < len(a):
                f.write(a[full:].tobytes() + b"\n")
    queries = {"cdna": [], "protein": []}
    with open(os.path.join(outdir, "cdna.fa"), "w") as f:
        for g in cdna_genes:
            q = f"{g['name']}_mrna"
            f.write(f">{q}\n{_mutate(rng, g['cds'], spec.sub_rate)}\n")
            queries["cdna"].append({"name": q, "gene": g["name"]})
    with open(os.path.join(outdir, "protein.fa"), "w") as f:
        for g in prot_genes:
            q = f"{g['name']}_prot"
            f.write(f">{q}\n{g['protein']}\n")
            queries["protein"].append({"name": q, "gene": g["name"]})
    for g in genes:
        del g["_exons"], g["_introns"]
    truth = {"seed": seed,
             "chroms": [[c, int(len(chroms[c]))] for c in names],
             "genes": genes, "queries": queries}
    with open(os.path.join(outdir, "truth.json"), "w") as f:
        json.dump(truth, f)
    return truth


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    a = ap.parse_args(argv)
    t = make_dataset(a.outdir, a.seed, TINY if a.tiny else FULL)
    print(f"{len(t['genes'])} genes, {len(t['queries']['cdna'])} cDNA and "
          f"{len(t['queries']['protein'])} protein queries -> {a.outdir}")


if __name__ == "__main__":
    main()
