"""SWG local mode + colony extraction (fwdswgB_ng / Colonies role)."""
import numpy as np
import pytest

from spaln_tpu.align.protein_search import search_protein_local
from spaln_tpu.seq.codec import encode_protein

AAS = list("ARNDCQEGHILKMFPSTWYV")


def test_local_two_islands(table_dir):
    rng = np.random.default_rng(7)
    """Two homologous blocks whose separation costs more than either
    block scores must come back as two distinct local alignments (the
    connecting gap would wipe out the smaller island's score, so SWG
    restarts instead)."""
    blk1 = "".join(rng.choice(AAS, 20))
    blk2 = "".join(rng.choice(AAS, 18))
    query = blk1 + "".join(rng.choice(AAS, 120)) + blk2
    subject = ("".join(rng.choice(AAS, 30)) + blk1
               + "".join(rng.choice(AAS, 200)) + blk2
               + "".join(rng.choice(AAS, 20)))
    hits = search_protein_local(encode_protein(query),
                                [("s", encode_protein(subject))],
                                table_dir=table_dir.root,
                                max_out=4, lanes=32)
    assert len(hits) >= 2
    spans = sorted(h.s_span for h in hits[:2])
    # island 1 at subject[30:50], island 2 at subject[250:268]
    assert abs(spans[0][0] - 30) <= 2 and abs(spans[0][1] - 50) <= 2
    assert abs(spans[1][0] - 250) <= 2 and abs(spans[1][1] - 268) <= 2
    for h in hits[:2]:
        assert h.identity > 0.95


def test_local_score_matches_swg_oracle(table_dir):
    rng = np.random.default_rng(8)
    """Single-island local score == a numpy Smith-Waterman-Gotoh."""
    from spaln_tpu.config import Config, resolve, PvsP
    from spaln_tpu.score.simmtx import Simmtx
    q = "".join(rng.choice(AAS, 30))
    s = ("".join(rng.choice(AAS, 15)) + q[5:25]
         + "".join(rng.choice(AAS, 15)))
    hits = search_protein_local(encode_protein(q),
                                [("s", encode_protein(s))],
                                table_dir=table_dir.root,
                                max_out=1, lanes=16)
    assert hits
    cfg = resolve(Config(), PvsP)
    sm = Simmtx.protein(table_dir.root, slot=0)
    from spaln_tpu.ops.params import DpParams
    prm = DpParams.build(cfg, sm, PvsP)
    gop, gep = prm.gop, prm.gep
    qc, sc = encode_protein(q), encode_protein(s)
    M, N = len(qc), len(sc)
    H = np.zeros((M + 1, N + 1), np.int64)
    E = np.full((M + 1, N + 1), -10**9, np.int64)
    F = np.full((M + 1, N + 1), -10**9, np.int64)
    best = 0
    for m in range(1, M + 1):
        for n in range(1, N + 1):
            E[m][n] = max(E[m][n - 1], H[m][n - 1] + gop) + gep
            F[m][n] = max(F[m - 1][n], H[m - 1][n] + gop) + gep
            d = H[m - 1][n - 1] + int(sm.mtx[qc[m - 1], sc[n - 1]])
            H[m][n] = max(0, d, E[m][n], F[m][n])
            best = max(best, H[m][n])
    assert hits[0].score == best
