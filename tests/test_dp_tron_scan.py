"""Differential tests: tron wavefront scan vs the scalar tron oracle."""
import numpy as np
import pytest

from spaln_tpu import constants as K
from spaln_tpu.config import Config, resolve, PvsG
from spaln_tpu.ops.dp_tron_ref import (TronDpParams, forward_tron_ref,
                                       traceback_tron_ref)
from spaln_tpu.ops.dp_tron_scan import (forward_tron_scan,
                                        traceback_tron_scan)
from spaln_tpu.score.codepot import build_tron_signals
from spaln_tpu.score.intron import IntronPenalty
from spaln_tpu.score.simmtx import Simmtx
from spaln_tpu.seq.codec import encode_dna

_CODON = {}
for _i in range(64):
    _aa = int(K.GENCODE[_i])
    _CODON.setdefault(_aa, "ACGT"[(_i >> 4) & 3] + "ACGT"[(_i >> 2) & 3]
                      + "ACGT"[_i & 3])
AA_CODES = list(range(3, 23))


@pytest.fixture(scope="module")
def cfg():
    return resolve(Config(), PvsG)


@pytest.fixture(scope="module")
def prm(cfg, table_dir):
    sm = Simmtx.protein(table_dir.root, slot=0).tron()
    return TronDpParams.build(cfg, sm.mtx)


@pytest.fixture(scope="module")
def ipen_tab(cfg):
    return IntronPenalty(cfg, PvsG).penalty(np.arange(20000))


def _bt(aa):
    return "".join(_CODON[int(x)] for x in aa)


def _cmp(prot, genome, cfg, prm, ipen_tab, table_dir, L, flags=None):
    gc = encode_dna(genome)
    sig = build_tron_signals(gc, cfg, table_dir)
    s_r, em_r, en_r, tb_r = forward_tron_ref(prot, gc, sig, prm, ipen_tab,
                                             flags=flags)
    s_j, em_j, en_j, tr_j = forward_tron_scan(prot, gc, sig, prm, ipen_tab,
                                              L=L, flags=flags)
    assert (s_j, em_j, en_j) == (s_r, em_r, en_r)
    ops_r = traceback_tron_ref(tb_r, em_r, en_r)
    ops_j = traceback_tron_scan(tr_j, em_j, en_j)
    assert ops_j == ops_r
    return ops_r


def test_tron_scan_single_exon(cfg, prm, ipen_tab, table_dir, rng):
    aa = rng.choice(AA_CODES, 30).astype(np.int8)
    g = ("".join(rng.choice(list("ACGT"), 20)) + _bt(aa)
         + "".join(rng.choice(list("ACGT"), 20)))
    _cmp(aa, g, cfg, prm, ipen_tab, table_dir, L=8)


def test_tron_scan_intron_multislab(cfg, prm, ipen_tab, table_dir, rng):
    aa1 = rng.choice(AA_CODES, 35)
    aa2 = rng.choice(AA_CODES, 42)
    intron = "GTAAGT" + "".join(rng.choice(list("ACGT"), 200)) + "TTTCTAG"
    g = ("".join(rng.choice(list("ACGT"), 30)) + _bt(aa1) + intron
         + _bt(aa2) + "".join(rng.choice(list("ACGT"), 25)))
    prot = np.concatenate([aa1, aa2]).astype(np.int8)
    ops = _cmp(prot, g, cfg, prm, ipen_tab, table_dir, L=8)  # 10 slabs
    assert len([o for o in ops if o[0] == 'I']) == 1


@pytest.mark.parametrize("split", [1, 2])
def test_tron_scan_split_codon(cfg, prm, ipen_tab, table_dir, rng, split):
    aa1 = rng.choice(AA_CODES, 30)
    aa2 = rng.choice(AA_CODES, 30)
    mid = _CODON[int(K.LEU)]
    intron = "GTGAGT" + "".join(rng.choice(list("ACGT"), 150)) + "TTTACAG"
    g = _bt(aa1) + mid[:split] + intron + mid[split:] + _bt(aa2)
    prot = np.concatenate([aa1, [K.LEU], aa2]).astype(np.int8)
    ops = _cmp(prot, g, cfg, prm, ipen_tab, table_dir, L=16)
    assert len([o for o in ops if o[0] == 'I']) == 1


def test_tron_scan_frameshift(cfg, prm, ipen_tab, table_dir, rng):
    aa = rng.choice(AA_CODES, 40).astype(np.int8)
    g = _bt(aa)
    g = g[:60] + g[61:]                      # 1nt deletion
    _cmp(aa, g, cfg, prm, ipen_tab, table_dir, L=16)


def test_tron_scan_divergent(cfg, prm, ipen_tab, table_dir, rng):
    aa1 = rng.choice(AA_CODES, 25)
    aa2 = rng.choice(AA_CODES, 30)
    # mutate some codons' wobble position
    e1 = list(_bt(aa1))
    for i in range(2, len(e1), 9):
        e1[i] = rng.choice(list("ACGT"))
    intron = "GTAAGT" + "".join(rng.choice(list("ACGT"), 120)) + "TTTTTAG"
    g = "".join(e1) + intron + _bt(aa2)
    prot = np.concatenate([aa1, aa2]).astype(np.int8)
    _cmp(prot, g, cfg, prm, ipen_tab, table_dir, L=8)


# ------------------------------------------------------------- local
def test_tron_scan_local_basic(cfg, prm, ipen_tab, table_dir, rng):
    """SW local (-LS): scan == oracle on score, end, and path."""
    from spaln_tpu.ops.params import DpFlags
    aa = rng.choice(AA_CODES, 30).astype(np.int8)
    g = ("".join(rng.choice(list("ACGT"), 40)) + _bt(aa)
         + "".join(rng.choice(list("ACGT"), 40)))
    _cmp(aa, g, cfg, prm, ipen_tab, table_dir, L=8,
         flags=DpFlags(local=True))


def test_tron_scan_local_trims_junk_tail(cfg, prm, ipen_tab, table_dir,
                                         rng):
    """A query whose tail has no genomic support ends mid-matrix under
    LocalR instead of being dragged to the last row (fwd2h1.cc:608)."""
    from spaln_tpu.ops.params import DpFlags
    aa_core = rng.choice(AA_CODES, 40)
    aa_junk = rng.choice(AA_CODES, 15)
    prot = np.concatenate([aa_core, aa_junk]).astype(np.int8)
    g = _bt(aa_core) + "".join(rng.choice(list("ACGT"), 30))
    ops = _cmp(prot, g, cfg, prm, ipen_tab, table_dir, L=16,
               flags=DpFlags(local=True))
    last_m = max(o[1] for o in ops if o[0] == 'D')
    assert last_m <= 42                      # junk tail not aligned


def test_tron_scan_local_intron(cfg, prm, ipen_tab, table_dir, rng):
    """Local mode with a real intron, multi-slab."""
    from spaln_tpu.ops.params import DpFlags
    aa1 = rng.choice(AA_CODES, 35)
    aa2 = rng.choice(AA_CODES, 42)
    intron = "GTAAGT" + "".join(rng.choice(list("ACGT"), 200)) + "TTTCTAG"
    g = ("".join(rng.choice(list("ACGT"), 30)) + _bt(aa1) + intron
         + _bt(aa2) + "".join(rng.choice(list("ACGT"), 25)))
    prot = np.concatenate([aa1, aa2]).astype(np.int8)
    ops = _cmp(prot, g, cfg, prm, ipen_tab, table_dir, L=8,
               flags=DpFlags(local=True))
    assert len([o for o in ops if o[0] == 'I']) == 1


def test_tron_scan_local_divergent(cfg, prm, ipen_tab, table_dir, rng):
    """Local mode with mutated codons (negative-run clamp exercised)."""
    from spaln_tpu.ops.params import DpFlags
    aa1 = rng.choice(AA_CODES, 25)
    aa2 = rng.choice(AA_CODES, 30)
    e1 = list(_bt(aa1))
    for i in range(2, len(e1), 9):
        e1[i] = rng.choice(list("ACGT"))
    intron = "GTAAGT" + "".join(rng.choice(list("ACGT"), 120)) + "TTTTTAG"
    g = "".join(e1) + intron + _bt(aa2)
    prot = np.concatenate([aa1, aa2]).astype(np.int8)
    _cmp(prot, g, cfg, prm, ipen_tab, table_dir, L=8,
         flags=DpFlags(local=True))


# ------------------------------------------------------------- dagp
@pytest.fixture(scope="module")
def prm_dagp(cfg, table_dir):
    from dataclasses import replace
    sm = Simmtx.protein(table_dir.root, slot=0).tron()
    base = TronDpParams.build(cfg, sm.mtx)
    lgep = -int(0.6 * cfg.aln.scale)
    lgop = base.gop - (lgep - base.gep) * 7
    return replace(base, dagp=True, lgop=lgop, lgep=lgep)


def test_tron_scan_dagp_long_deletion(cfg, prm_dagp, ipen_tab, table_dir,
                                      rng):
    """20-codon deletion through F2 (VERL): scan == oracle, dagp."""
    aa = rng.choice(AA_CODES, 70).astype(np.int8)
    g = _bt(aa)
    g = g[:90] + g[150:]                     # drop 20 codons
    ops = _cmp(aa, g, cfg, prm_dagp, ipen_tab, table_dir, L=16)
    fops = [o for o in ops if o[0] == 'F']
    assert len(fops) == 20


def test_tron_scan_dagp_long_insertion(cfg, prm_dagp, ipen_tab, table_dir,
                                       rng):
    """20-codon A/C-only genomic insertion through E2 (HORL)."""
    aa = rng.choice(AA_CODES, 70).astype(np.int8)
    g = _bt(aa)
    ins = "".join(rng.choice(list("AC"), 60))
    g = g[:120] + ins + g[120:]
    ops = _cmp(aa, g, cfg, prm_dagp, ipen_tab, table_dir, L=16)
    eops = [o for o in ops if o[0] == 'E']
    assert len(eops) == 20 and all(o[3] == 3 for o in eops)


def test_tron_scan_dagp_intron(cfg, prm_dagp, ipen_tab, table_dir, rng):
    """dagp with a real intron + multi-slab boundary crossing."""
    aa1 = rng.choice(AA_CODES, 35)
    aa2 = rng.choice(AA_CODES, 42)
    intron = "GTAAGT" + "".join(rng.choice(list("ACGT"), 200)) + "TTTCTAG"
    g = ("".join(rng.choice(list("ACGT"), 30)) + _bt(aa1) + intron
         + _bt(aa2) + "".join(rng.choice(list("ACGT"), 25)))
    prot = np.concatenate([aa1, aa2]).astype(np.int8)
    ops = _cmp(prot, g, cfg, prm_dagp, ipen_tab, table_dir, L=8)
    assert len([o for o in ops if o[0] == 'I']) == 1


def test_tron_scan_dagp_mixed(cfg, prm_dagp, ipen_tab, table_dir, rng):
    """Long deletion + intron + frameshift in one gene, dagp on."""
    aa1 = rng.choice(AA_CODES, 40)
    aa2 = rng.choice(AA_CODES, 40)
    e1 = _bt(aa1)
    e1 = e1[:30] + e1[66:]                   # 12-codon deletion
    intron = "GTGAGT" + "".join(rng.choice(list("ACGT"), 150)) + "TTTACAG"
    e2 = _bt(aa2)
    e2 = e2[:45] + e2[46:]                   # 1-nt frameshift
    g = e1 + intron + e2
    prot = np.concatenate([aa1, aa2]).astype(np.int8)
    _cmp(prot, g, cfg, prm_dagp, ipen_tab, table_dir, L=16)


def test_tron_device_traceback_matches_host(cfg, prm, ipen_tab,
                                            table_dir, rng):
    """traceback_tron_device == the host plane walk, op for op."""
    from spaln_tpu.ops.dp_tron_scan import (prepare_tron_batch,
                                            run_tron_batch,
                                            collect_tron_results,
                                            traceback_tron_device)
    probs = []
    for i in range(3):
        aa1 = rng.choice(AA_CODES, 30 + i)
        aa2 = rng.choice(AA_CODES, 35)
        intron = ("GTAAGT" + "".join(rng.choice(list("ACGT"), 150))
                  + "TTTCTAG")
        g = (_bt(aa1) + intron + _bt(aa2)
             + "".join(rng.choice(list("ACGT"), 20)))
        probs.append((np.concatenate([aa1, aa2]).astype(np.int8),
                      encode_dna(g)))
    sigs = [build_tron_signals(g, cfg, table_dir) for _, g in probs]
    bp = prepare_tron_batch([q for q, _ in probs], [g for _, g in probs],
                            sigs, prm, ipen_tab, L=16)
    row_np, rc_np, traces = run_tron_batch(bp, prm, score_only=False,
                                           keep_device=True)
    res = collect_tron_results(bp, row_np, rc_np, traces, True)
    ops_dev = traceback_tron_device(bp, traces,
                                    [(r[1], r[2]) for r in res])
    row_h, rc_h, traces_np = run_tron_batch(bp, prm, score_only=False)
    res_h = collect_tron_results(bp, row_h, rc_h, traces_np, False)
    for b in range(3):
        s, em, en, tr = res_h[b]
        ops_host = traceback_tron_scan(tr, em, en)
        assert ops_dev[b] == ops_host
