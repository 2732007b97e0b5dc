"""The planted truth of scripts/synth_genes.py, checked with the
package's own sequence code: canonical sites, lengths within the spec,
proteins that translate the planted CDS, cDNAs that are the spliced
transcripts."""
import os
import sys

import numpy as np
import pytest

from spaln_tpu.seq.codec import (decode_dna, decode_protein, encode_dna,
                                 translate)
from spaln_tpu.seq.fasta import read_fasta

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import synth_genes as synth  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth"))
    truth = synth.make_dataset(out, seed=5, spec=synth.TINY)
    genome = {r.name: r for r in read_fasta(os.path.join(out,
                                                         "genome.fa"))}
    return out, truth, genome


def _dec(genome, chrom, a, b):
    return decode_dna(genome[chrom].codes[a:b])


def _transcript(genome, g):
    s = "".join(_dec(genome, g["chrom"], a, b) for a, b in g["exons"])
    return s if g["strand"] == "+" else synth.revcomp(s)


def test_truth_sites_and_lengths(data):
    out, truth, genome = data
    spec = synth.TINY
    assert [c for c, _ in truth["chroms"]] == [c for c, _ in spec.chroms]
    spans = {}
    for g in truth["genes"]:
        ex, it = g["exons"], g["introns"]
        assert spec.n_exons[0] <= len(ex) <= spec.n_exons[1]
        assert len(it) == len(ex) - 1
        for (a, b), (c, d) in zip(ex, ex[1:]):
            assert (b, c) in {tuple(x) for x in it}
        for a, b in it:
            assert spec.intron_len[0] <= b - a <= spec.intron_len[1]
            s = _dec(genome, g["chrom"], a, b)
            if g["strand"] == "+":
                assert s[:2] == "GT" and s[-2:] == "AG"
            else:
                assert s[:2] == "CT" and s[-2:] == "AC"
        if g["paralog_of"] is None:
            for a, b in ex[1:-1]:
                assert spec.exon_len[0] <= b - a <= spec.exon_len[1]
        spans.setdefault(g["chrom"], []).append((g["start"], g["end"]))
    for iv in spans.values():
        iv.sort()
        assert all(b <= c for (_, b), (c, _) in zip(iv, iv[1:]))


def test_truth_proteins_translate_the_planted_cds(data):
    out, truth, genome = data
    genes = {g["name"]: g for g in truth["genes"]}
    prots = {r.name: decode_protein(r.codes)
             for r in read_fasta(os.path.join(out, "protein.fa"))}
    assert len(prots) == synth.TINY.n_protein
    for q in truth["queries"]["protein"]:
        cds = _transcript(genome, genes[q["gene"]])
        aa = decode_protein(translate(encode_dna(cds)))
        assert aa[:1] == "M" and aa[-1] in "*O"
        assert aa[:-1] == prots[q["name"]]


def test_cdna_queries_are_the_spliced_transcripts(data):
    out, truth, genome = data
    genes = {g["name"]: g for g in truth["genes"]}
    seqs = {r.name: np.asarray(r.codes)
            for r in read_fasta(os.path.join(out, "cdna.fa"))}
    assert len(seqs) == synth.TINY.n_cdna
    for q in truth["queries"]["cdna"]:
        tx = encode_dna(_transcript(genome, genes[q["gene"]]))
        got = seqs[q["name"]]
        assert len(got) == len(tx)
        assert np.mean(got == tx) >= 0.95
