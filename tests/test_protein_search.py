import numpy as np
import pytest

from spaln_tpu.align.protein_search import search_protein_db
from spaln_tpu.seq.codec import encode_protein


AAS = list("ARNDCQEGHILKMFPSTWYV")


def _mut(rng, s, rate):
    return "".join(rng.choice(AAS) if rng.random() < rate else c for c in s)


def test_protein_db_search_ranks_homolog(table_dir, rng):
    target = "".join(rng.choice(AAS, 120))
    db = []
    for i in range(20):
        decoy = "".join(rng.choice(AAS, int(rng.integers(80, 160))))
        db.append((f"decoy{i}", encode_protein(decoy)))
    homolog = _mut(rng, target, 0.15)
    db.insert(7, ("homolog", encode_protein(homolog)))
    hits = search_protein_db(encode_protein(target), db,
                             table_dir=table_dir.root,
                             max_hits=5, align_top=1, lanes=32)
    assert hits[0].name == "homolog"
    assert hits[0].structure is not None
    assert hits[0].identity > 0.7
    assert hits[0].score > 2 * hits[1].score


def test_protein_db_search_blosum(table_dir, rng):
    target = "".join(rng.choice(AAS, 80))
    db = [("self", encode_protein(target)),
          ("junk", encode_protein("".join(rng.choice(AAS, 80))))]
    hits = search_protein_db(encode_protein(target), db,
                             matrix=table_dir.path("blosum62"),
                             max_hits=2, lanes=32)
    assert hits[0].name == "self"
    assert hits[0].identity == 1.0


def test_protein_db_prefilter_matches_full(table_dir, rng):
    """The k-mer prefilter (SrchBlk::finds role) must return the same
    ranked hits as exhaustive DP on a DB with homologs of varying
    divergence."""
    target = "".join(rng.choice(AAS, 100))
    db = []
    for i in range(60):
        db.append((f"decoy{i}",
                   encode_protein("".join(rng.choice(
                       AAS, int(rng.integers(60, 140)))))))
    for j, rate in enumerate((0.05, 0.2, 0.35)):
        db.insert(11 * (j + 1), (f"hom{j}",
                                 encode_protein(_mut(rng, target, rate))))
    q = encode_protein(target)
    full = search_protein_db(q, db, table_dir=table_dir.root,
                             max_hits=4, align_top=0, lanes=32,
                             prefilter=False)
    fast = search_protein_db(q, db, table_dir=table_dir.root,
                             max_hits=4, align_top=0, lanes=32,
                             prefilter=True)
    # every real (above-random) hit must survive the prefilter with an
    # identical DP score; random-level tail entries may differ (they
    # fall below the Randbs seed threshold by design)
    assert [h.name for h in fast[:3]] == [h.name for h in full[:3]] \
        == ["hom0", "hom1", "hom2"]
    assert [h.score for h in fast[:3]] == [h.score for h in full[:3]]


def test_protein_db_index_prunes(rng):
    """The prefilter actually prunes: unrelated entries fall below the
    Randbs threshold while homologs survive."""
    from spaln_tpu.seed.dbindex import ProteinDbIndex
    target = "".join(rng.choice(AAS, 120))
    db = [(f"d{i}", encode_protein("".join(rng.choice(AAS, 120))))
          for i in range(200)]
    db.append(("hom", encode_protein(_mut(rng, target, 0.1))))
    idx = ProteinDbIndex.build(db)
    cand = idx.candidates(encode_protein(target), max_cand=50,
                          min_hits=5)
    assert len(cand) < 100                    # pruned hard
    assert 200 in cand                        # the homolog survives
    assert cand[0] == 200                     # and ranks first by vote
