"""Command-line interface.

The spaln-equivalent entry points (spaln.cc:152-516 option surface,
re-organized as subcommands):

  spaln_tpu align    <genomic.fa> <queries.fa>  no-index alignment (-Q0..3)
  spaln_tpu index    <genome.fa> -K D|P|DP      build block index (-W)
  spaln_tpu map      <queries.fa> -d <genome>   indexed genome mapping (-Q7)
  spaln_tpu sortgrcd <run1.grd.npz> ...         merge/cluster/filter runs

Output formats -O#[,#2,..] (spaln.cc:196-198 numbering): 0 GFF3 gene,
1 alignment text, 2 GFF3 match, 3 BED12, 4 exon table, 5 intron table,
6 recovered cDNA, 7 translated protein, 10 SAM, 12 binary shard
(.grd.npz), 15 unique introns.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .align.driver import AlignerContext, align_cdna
from .config import Config
from .out.formats import (alignment_lines, bed_line, cdna_fasta,
                          exon_table_lines, gff3_lines, gff3_match_lines,
                          intron_lines, sam_line, translated_fasta)
from .score.tables import TableDir, find_table_dir
from .seq.fasta import iter_fasta, iter_seqfile, parse_seq_arg, \
    read_fasta
from .seq.genome import GenomeStore
from .constants import DNA


def _ktoi(s: str) -> int:
    """Parse a size with k/M/G suffix (the reference's ktoi/ktol)."""
    s = s.strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult)


def _lcl_local(args, default: bool = False) -> bool:
    """-L value -> SW-local flag (spaln.cc:361-379: S/16 = local)."""
    v = getattr(args, "lcl", None)
    if v is None:
        return default
    if v.isdigit():
        return bool(int(v) & 16)
    return v.upper().startswith("S")


def _seed_level(args) -> int:
    """-Q level -> starting Wilip seed level (algmode.qck depth:
    deeper recursion budget starts at the finest seed)."""
    q = getattr(args, "qlevel", 7) & 3
    return {3: 0, 2: 1, 1: 2, 0: 2}[q]


def _apply_engine_opts(args) -> None:
    """-A/-V/-G wiring: engine force + memory/segment budgets."""
    eng = getattr(args, "engine", None)
    if eng not in (None, 1, 3):
        raise SystemExit(f"-A {eng} is not an engine: use -A 1 (scan, "
                         "full traceback planes) or -A 3 (linear-space "
                         "UDH)")
    if eng == 3:
        from .align import driver as _drv
        _drv.FORCE_UDH = True
    if getattr(args, "vmf_budget", None):
        from .align import driver as _drv
        _drv.PLANE_BYTES_BUDGET = _ktoi(args.vmf_budget)
    if getattr(args, "g_segment", None):
        from .align import segment as _seg
        _seg.G_SEGMENT = _ktoi(args.g_segment)
    # -u/-v/-w are readalprm letters spelled as their own flags
    for flag, letter in (("u_pen", "u"), ("v_pen", "v"),
                         ("w_band", "w")):
        v = getattr(args, flag, None)
        if v is not None:
            args.y_args.append(f"{letter}{v}")


class OutputSink:
    """Multi-format writer (AlnOutModes role, aln.h:312-333): one pass
    over results feeds every requested -O form; -O12 shards collect in
    memory and flush as one .grd.npz per run."""

    def __init__(self, fmts: list[int], out, grd_path: str = "run"):
        self.fmts = fmts
        self.out = out
        self.gene_id = 1
        self.grd_path = grd_path
        self.bin_records = []
        self.q_lens = {}
        if 0 in fmts or 2 in fmts:
            out.write("##gff-version 3\n")

    def emit(self, gs_list, q_len: int) -> None:
        w = self.out.write
        for gs in gs_list:
            for fmt in self.fmts:
                if fmt == 0:
                    w("\n".join(gff3_lines(gs, q_len=q_len,
                                           gene_id=self.gene_id)) + "\n")
                elif fmt == 1:
                    w("\n".join(alignment_lines(gs)) + "\n")
                elif fmt == 2:
                    w("\n".join(gff3_match_lines(
                        gs, q_len=q_len, gene_id=self.gene_id)) + "\n")
                elif fmt == 3:
                    w(bed_line(gs) + "\n")
                elif fmt == 4:
                    w("\n".join(exon_table_lines(gs, q_len=q_len)) + "\n")
                elif fmt == 5:
                    lines = intron_lines(gs)
                    if lines:
                        w("\n".join(lines) + "\n")
                elif fmt == 6:
                    w("\n".join(cdna_fasta(gs)) + "\n")
                elif fmt == 7:
                    w("\n".join(translated_fasta(gs)) + "\n")
                elif fmt == 10:
                    w(sam_line(gs, q_len=q_len) + "\n")
                elif fmt in (12, 15):
                    pass                   # collected below
                else:
                    raise SystemExit(f"unsupported output format -O{fmt}")
            if 12 in self.fmts or 15 in self.fmts:
                self.bin_records.append(gs)
                self.q_lens[gs.q_name] = q_len
            self.gene_id += 1

    def close(self) -> None:
        if 12 in self.fmts and self.bin_records:
            from .out.sortgrcd import write_grd
            write_grd(self.grd_path + ".grd.npz", self.bin_records,
                      self.q_lens)
            print(f"binary shard -> {self.grd_path}.grd.npz",
                  file=sys.stderr)
        if 15 in self.fmts:
            from .out.sortgrcd import unique_introns
            for row in unique_introns(self.bin_records):
                self.out.write("\t".join(map(str, row)) + "\n")


def _parse_fmts(s) -> list[int]:
    return [int(x) for x in str(s).split(",")]


def cmd_align(args) -> int:
    from .constants import PROTEIN
    tables = TableDir(find_table_dir(args.table_dir), species=args.species)
    gpath, g_from, g_to = parse_seq_arg(args.genomic)
    genome_recs = list(iter_seqfile(gpath, molc=DNA))
    if g_from is not None:
        for grec in genome_recs:
            grec.codes = grec.codes[g_from:g_to]
    out = open(args.output, "w") if args.output else sys.stdout
    sink = OutputSink(_parse_fmts(args.fmt), out,
                      grd_path=(args.output or "run").rsplit(".", 1)[0])
    ctx = pctx = None
    from .align.segment import G_SEGMENT, annotate_segment
    recs = list(iter_seqfile(args.queries))
    need_p = any(r.molc == PROTEIN for r in recs)
    need_n = any(r.molc != PROTEIN for r in recs)
    _apply_engine_opts(args)
    ya = ["-y" + a for a in args.y_args]
    if need_p:
        from .align.protein_driver import (ProteinAlignerContext,
                                           align_protein)
        pctx = ProteinAlignerContext.create(
            tables, y_args=ya,
            local=(_lcl_local(args) if args.lcl is not None else None))
    if need_n:
        ctx = AlignerContext.create(tables, y_args=ya,
                                    local=_lcl_local(args))
    for grec in genome_recs:
        if len(grec.codes) > G_SEGMENT:
            # long genomic query: chunked annotation with seam stitching
            gss = annotate_segment(
                grec.codes, [r.codes for r in recs], ctx=ctx, pctx=pctx,
                q_names=[r.name for r in recs],
                molc_is_aa=[r.molc == PROTEIN for r in recs],
                g_name=grec.name, lanes=args.lanes, strand=args.strand)
            qlen = {r.name: len(r.codes) for r in recs}
            for gs in gss:
                sink.emit([gs], qlen.get(gs.q_name, 0))
            continue
        from .utils.errors import guard_query
        for rec in recs:
            if rec.molc == PROTEIN:
                gs_list = guard_query(
                    align_protein, rec.codes, grec.codes, pctx,
                    strand=args.strand, q_name=rec.name,
                    g_name=grec.name, lanes=args.lanes,
                    name=rec.name, stage="align", fallback=[])
            else:
                gs_list = guard_query(
                    align_cdna, rec.codes, grec.codes, ctx,
                    strand=args.strand, q_name=rec.name,
                    g_name=grec.name, lanes=args.lanes,
                    name=rec.name, stage="align", fallback=[])
            sink.emit(gs_list, len(rec.codes))
    sink.close()
    if args.output:
        out.close()
    return 0


def cmd_index(args) -> int:
    from .seed.blockindex import BlockIndex, ProteinBlockIndex
    store = GenomeStore.from_fasta(args.genome, molc=DNA)
    prefix = args.prefix or args.genome.rsplit(".", 1)[0]
    store.save(prefix)
    kinds = args.kind.upper()
    if "D" in kinds:
        BlockIndex.build(store).save(prefix)
        print(f"indexed {store.n_contigs} contigs, {store.total_len} "
              f"bases -> {prefix}.bkn.npz", file=sys.stderr)
    if "P" in kinds:
        ProteinBlockIndex.build(store, nalpha=args.nalpha,
                                min_orf=args.min_orf).save(prefix)
        print(f"6-frame protein index -> {prefix}.bkp.npz",
              file=sys.stderr)
    return 0


def cmd_map(args) -> int:
    from .constants import PROTEIN
    from .seed.blockindex import BlockIndex, ProteinBlockIndex
    from .align.mapper import GenomeMapper, ProteinGenomeMapper
    _apply_engine_opts(args)
    store = GenomeStore.load(args.genome_db)
    tables = TableDir(find_table_dir(args.table_dir), species=args.species)
    out = open(args.output, "w") if args.output else sys.stdout
    fmts = _parse_fmts(args.fmt)
    if 10 in fmts:
        # SAM @SQ headers (put_genome_entries, spaln.cc:1209-1218)
        for name, ln in zip(store.names, store.lengths):
            out.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
    sink = OutputSink(fmts, out,
                      grd_path=(args.output or "run").rsplit(".", 1)[0])
    mapper = pmapper = None
    nt_batch: list = []            # (rec) pending cDNA queries
    aa_batch: list = []            # (rec) pending protein queries
    bs = max(args.batch, 1)

    def flush_aa():
        nonlocal pmapper
        if not aa_batch:
            return
        if pmapper is None:
            from .align.protein_driver import ProteinAlignerContext
            pmapper = ProteinGenomeMapper(
                store, ProteinBlockIndex.load(args.genome_db),
                ProteinAlignerContext.create(
                    tables, y_args=["-y" + a for a in args.y_args],
                    local=(_lcl_local(args) if args.lcl is not None
                           else None)))
        res = pmapper.map_queries([r.codes for r in aa_batch],
                                  q_names=[r.name for r in aa_batch],
                                  lanes=args.lanes,
                                  max_out=args.max_out, max_batch=bs)
        for rec, gs_list in zip(aa_batch, res):
            sink.emit(gs_list, len(rec.codes))
        aa_batch.clear()

    def flush_nt():
        nonlocal mapper
        if not nt_batch:
            return
        if mapper is None:
            mapper = GenomeMapper(
                store, BlockIndex.load(args.genome_db),
                AlignerContext.create(
                    tables, y_args=["-y" + a for a in args.y_args],
                    local=_lcl_local(args)))
        # -yJ: queries carrying SigII junction records (;B/;b) get the
        # conserved-intron-position bonus SpbFact*num at those rows
        spb = mapper.ctx.cfg.aln2.spb * mapper.ctx.cfg.aln.scale
        cips = [({p: int(spb * c) for p, c in r.meta["sig_pos"]}
                 if spb > 0 and "sig_pos" in r.meta else None)
                for r in nt_batch]
        res = mapper.map_queries([r.codes for r in nt_batch],
                                 q_names=[r.name for r in nt_batch],
                                 strand=args.strand, lanes=args.lanes,
                                 max_out=args.max_out, max_batch=bs,
                                 cips=cips if any(cips) else None)
        for rec, gs_list in zip(nt_batch, res):
            sink.emit(gs_list, len(rec.codes))
        nt_batch.clear()

    for rec in iter_seqfile(args.queries):
        if rec.molc == PROTEIN:
            flush_nt()
            aa_batch.append(rec)
            if len(aa_batch) >= 4 * bs:
                flush_aa()
        else:
            flush_aa()
            nt_batch.append(rec)
            if len(nt_batch) >= 4 * bs:
                flush_nt()
    flush_nt()
    flush_aa()
    sink.close()
    if args.output:
        out.close()
    return 0


def cmd_sortgrcd(args) -> int:
    from .out.sortgrcd import (FilterParams, cluster_loci, locus_report,
                               merge_grd, sort_records, unique_introns)
    records, q_lens = merge_grd(args.shards)
    out = open(args.output, "w") if args.output else sys.stdout
    filt = FilterParams.preset(args.filter)
    if args.min_coverage is not None:
        filt.min_coverage = args.min_coverage
    if args.min_identity is not None:
        filt.min_identity = args.min_identity
    if args.min_score is not None:
        filt.min_score = args.min_score
    if args.bmmc is not None:
        filt.bmmc = args.bmmc
    if args.bunp is not None:
        filt.bunp = args.bunp
    if args.ncan is not None:
        filt.ncan = args.ncan
    fmts = _parse_fmts(args.fmt)
    if 15 in fmts:
        for row in unique_introns(records):
            out.write("\t".join(map(str, row)) + "\n")
    else:
        loci = cluster_loci(records, q_lens=q_lens, filt=filt)
        if args.sort_order != "a":
            from .out.sortgrcd import sort_records as _sr
            members = [g for lo in loci for g in lo.members]
            loci = cluster_loci(_sr(members, order=args.sort_order),
                                q_lens=q_lens, filt=FilterParams())
        for line in locus_report(loci):
            out.write(line + "\n")
    if args.output:
        out.close()
    return 0


def cmd_search(args) -> int:
    """Protein vs protein-DB search (the spaln -a mode, AvsA)."""
    from .align.protein_search import search_protein_db
    from .out.formats import (alignment_lines, hit_stat_line, psl_line,
                              sam_line, sugar_line, skl_lines, xyl_line,
                              xyl2_lines, boundary_line)
    from .constants import PROTEIN
    db = [(r.name, r.codes) for r in iter_seqfile(args.db, molc=PROTEIN)]
    out = open(args.output, "w") if args.output else sys.stdout
    fmts = _parse_fmts(args.fmt)
    from .utils.errors import guard_query
    for rec in iter_seqfile(args.queries, molc=PROTEIN):
        hits = guard_query(search_protein_db, rec.codes, db,
                           table_dir=find_table_dir(args.table_dir),
                           max_hits=args.max_hits,
                           align_top=args.align_top, lanes=args.lanes,
                           name=rec.name, stage="search", fallback=[])
        for hit in hits:
            gs = hit.structure
            for fmt in fmts:
                if fmt == 0:
                    out.write(f"{rec.name}\t" + hit_stat_line(hit) + "\n")
                elif gs is None:
                    continue
                elif fmt == 1:
                    out.write("\n".join(alignment_lines(gs)) + "\n")
                elif fmt == 2:
                    out.write(sugar_line(gs) + "\n")
                elif fmt == 3:
                    out.write(psl_line(gs, q_len=len(rec.codes),
                                       t_len=dict(db)[hit.name].size)
                              + "\n")
                elif fmt == 8:
                    out.write(gs.cigar() + "\n")
                elif fmt == 9:
                    out.write(gs.vulgar() + "\n")
                elif fmt == 10:
                    out.write(sam_line(gs, q_len=len(rec.codes)) + "\n")
                # repalninf report family (sqpr.cc:130-330)
                elif fmt == 4:
                    out.write(xyl_line(gs) + "\n")
                elif fmt == 5:
                    out.write(boundary_line(gs) + "\n")
                elif fmt == 6:
                    out.write("\n".join(xyl2_lines(gs)) + "\n")
                elif fmt == 7:
                    out.write("\n".join(skl_lines(gs)) + "\n")
                else:
                    raise SystemExit(f"unsupported AvsA format -O{fmt}")
    if args.output:
        out.close()
    return 0


def make_pairs(recs_a: list, recs_b: list | None, mode: str,
               split: int = 1) -> list | None:
    """SeqServer input-mode pairing (cmn.h:104-105, calcserv.h:309-355):
    para = two parallel files; altr = one file, alternating entries;
    grup = group 1 (first `split` entries) x group 2 (the rest);
    every = all-vs-all; fvso = first vs others; self = each vs itself.
    Returns None on an invalid mode/argument combination."""
    if recs_b is not None and mode in ("auto", "para"):
        if len(recs_a) != len(recs_b):
            print(f"warning: unpaired inputs ({len(recs_a)} vs "
                  f"{len(recs_b)}); extra entries skipped",
                  file=sys.stderr)
        return list(zip(recs_a, recs_b))
    if mode == "para":
        print("pair --mode para needs two input files", file=sys.stderr)
        return None
    if recs_b is not None:
        print(f"warning: second input ignored in --mode {mode}",
              file=sys.stderr)
    if mode in ("auto", "altr"):           # alternating single file
        return list(zip(recs_a[0::2], recs_a[1::2]))
    if mode == "grup":                     # IM_GRUP: g1 x g2 cross
        if not 0 < split < len(recs_a):
            print("pair --mode grup needs 0 < --split < n entries",
                  file=sys.stderr)
            return None
        return [(ra, rb) for ra in recs_a[:split]
                for rb in recs_a[split:]]
    if mode == "every":                    # IM_EVRY: all-vs-all
        return [(recs_a[i], recs_a[j]) for i in range(len(recs_a))
                for j in range(i + 1, len(recs_a))]
    if mode == "fvso":                     # IM_FvsO: first vs others
        return [(recs_a[0], rb) for rb in recs_a[1:]]
    if mode == "self":                     # IM_SELF
        return [(ra, ra) for ra in recs_a]
    print(f"unknown pair mode {mode!r}", file=sys.stderr)
    return None


def cmd_pair(args) -> int:
    """Pairwise alignment over the SeqServer input modes (see
    make_pairs)."""
    from .align.protein_search import search_protein_db
    from .out.formats import (alignment_lines, hit_stat_line, psl_line,
                              sugar_line)
    from .constants import PROTEIN
    recs_a = list(iter_seqfile(args.a))
    recs_b = list(iter_seqfile(args.b)) if args.b else None
    pairs = make_pairs(recs_a, recs_b, args.mode, args.split)
    if pairs is None:
        return 2
    out = open(args.output, "w") if args.output else sys.stdout
    fmts = _parse_fmts(args.fmt)
    from .utils.errors import guard_query
    for ra, rb in pairs:
        hits = guard_query(search_protein_db, ra.codes,
                           [(rb.name, rb.codes)],
                           table_dir=find_table_dir(args.table_dir),
                           max_hits=1, align_top=1, lanes=args.lanes,
                           prefilter=False,
                           name=ra.name, stage="pair", fallback=[])
        for hit in hits:
            gs = hit.structure
            for fmt in fmts:
                if fmt == 0:
                    out.write(f"{ra.name}\t" + hit_stat_line(hit) + "\n")
                elif gs is None:
                    continue
                elif fmt == 1:
                    out.write("\n".join(alignment_lines(gs)) + "\n")
                elif fmt == 2:
                    out.write(sugar_line(gs) + "\n")
                elif fmt == 3:
                    out.write(psl_line(gs, q_len=len(ra.codes),
                                       t_len=len(rb.codes)) + "\n")
    if args.output:
        out.close()
    return 0


def _read_lengths(path):
    import numpy as np
    vals = []
    with open(path) as f:
        for line in f:
            for tok in line.split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    break
    return np.asarray(vals, dtype=np.float64)


def _fit_or_load(path, n_modes):
    """A file of intron lengths -> fit; a saved .ild.json -> load."""
    import json as _json
    from .tools.fitild import IldFit, fit_ild
    if path.endswith(".json"):
        d = _json.load(open(path))
        return IldFit(**d)
    return fit_ild(_read_lengths(path), n_modes=n_modes)


def cmd_ild(args) -> int:
    """ILD tool family (fitild/compild/decompild/plotild, src/*.cc)."""
    import dataclasses
    import json as _json
    from .tools.fitild import (compare_ilds, decompose_ild, ild_pdf,
                               plot_ild_text)
    import numpy as np
    out = open(args.output, "w") if args.output else sys.stdout
    if args.op == "fit":                   # fitild
        fit = _fit_or_load(args.files[0], args.modes)
        out.write(_json.dumps(dataclasses.asdict(fit)) + "\n")
        out.write("-yI" + fit.yI_line() + "\n")
    elif args.op == "compare":             # compild
        fits = [_fit_or_load(p, args.modes) for p in args.files]
        for i, fa in enumerate(fits):
            for j, fb in enumerate(fits[i + 1:], start=i + 1):
                d = compare_ilds(fa, fb)
                out.write(f"{args.files[i]}\t{args.files[j]}\t"
                          f"{d:.6f}\n")
    elif args.op == "decompose":           # decompild
        fit = _fit_or_load(args.files[0], args.modes)
        x = np.unique(np.geomspace(max(min(fit.mus) + 1, 10),
                                   args.x_max, 64).astype(int))
        rows = decompose_ild(fit, x)
        tot = ild_pdf(fit, x)
        out.write("#len\ttotal\t" + "\t".join(
            f"mode{i + 1}" for i in range(len(rows))) + "\n")
        for ci, xx in enumerate(x):
            out.write(f"{xx}\t{tot[ci]:.3e}\t" + "\t".join(
                f"{rows[mi][ci]:.3e}" for mi in range(len(rows)))
                + "\n")
    elif args.op == "plot":                # plotild
        fit = _fit_or_load(args.files[0], args.modes)
        lens = (_read_lengths(args.files[1])
                if len(args.files) > 1 else None)
        for line in plot_ild_text(fit, lens):
            out.write(line + "\n")
    if args.output:
        out.close()
    return 0


def cmd_seq(args) -> int:
    """Batch sequence toolbox (the utn command set, utn.cc:1412-1461):
    orf find/translate, poly-A trim, composition, mutate, forge random
    sequences, restriction sites, GenBank CDS extraction."""
    from .constants import PROTEIN
    from .seq.codec import comrev, decode_dna, decode_protein, translate
    from .seq.utilseq import rm_polya, find_orfs, composition
    from .tools.seqextras import (montseq, mutate_seq, read_renzyme,
                                  resite, extcds)
    out = open(args.output, "w") if args.output else sys.stdout
    op = args.op
    if op == "forge":
        for i, s in enumerate(montseq(args.count, args.length,
                                      protein=args.aa, seed=args.seed)):
            out.write(f">rand{i}\n{s}\n")
    elif op == "extcds":
        for rec in extcds(args.input):
            hdr = rec.entry + (f" {rec.product}" if rec.product else "")
            out.write(f">{hdr}\n{rec.seq}\n")
    else:
        if args.input is None:
            raise SystemExit(f"seq {op} needs an input file")
        enz = None
        if op == "resite":
            from .score.tables import find_table_dir
            import os
            rz = args.enzymes or os.path.join(
                find_table_dir(args.table_dir), "renzyme")
            enz = read_renzyme(rz)
        for rec in iter_seqfile(args.input):
            is_aa = rec.molc == PROTEIN
            dec = decode_protein if is_aa else decode_dna
            if op == "orf":
                for b0, b1, frame, strand in find_orfs(
                        rec.codes, min_len=args.min_orf):
                    sub = (rec.codes[b0:b1] if strand > 0
                           else comrev(rec.codes[b0:b1]))
                    pep = decode_protein(translate(sub))
                    out.write(f">{rec.name}_orf{b0 + 1}-{b1} "
                              f"frame {frame} strand "
                              f"{'+' if strand > 0 else '-'}\n{pep}\n")
            elif op == "polya":
                lo, hi, _ = rm_polya(rec.codes)
                out.write(f">{rec.name}\n{dec(rec.codes[lo:hi])}\n")
            elif op == "comp":
                comp = composition(rec.codes, is_aa=is_aa)
                line = " ".join(f"{k}:{v}" for k, v in sorted(comp.items()))
                out.write(f"{rec.name}\t{len(rec.codes)}\t{line}\n")
            elif op == "mutate":
                s = mutate_seq(dec(rec.codes), sub=args.sub, ins=args.ins,
                               del_=args.dele, protein=is_aa,
                               seed=args.seed)
                out.write(f">{rec.name}_mut\n{s}\n")
            elif op == "resite":
                for site in resite(dec(rec.codes), enz,
                                   unique_only=args.unique):
                    out.write(f"{rec.name}\t{site.enzyme}\t"
                              f"{site.pos + 1}\t{site.strand}\n")
            else:
                raise SystemExit(f"unknown seq op {op}")
    if args.output:
        out.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spaln_tpu",
                                description="spliced aligner for cDNA and "
                                            "protein queries")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("-O", dest="fmt", default="0",
                        help="output format(s), comma-separated: 0 gff3 "
                             "gene, 1 alignment, 2 gff3 match, 3 bed, "
                             "4 exon, 5 intron, 6 cDNA, 7 translated, "
                             "10 sam, 12 binary, 15 unique introns")
        sp.add_argument("-T", dest="species", default=None,
                        help="species/clade parameter set")
        sp.add_argument("-S", dest="strand", default="auto",
                        choices=["auto", "+", "-"])
        sp.add_argument("-t", dest="table_dir", default=None)
        sp.add_argument("-o", dest="output", default=None)
        sp.add_argument("--lanes", type=int, default=128)
        sp.add_argument("--metrics", action="store_true",
                        help="print per-stage counters/timings to stderr")
        sp.add_argument("-y", dest="y_args", action="append", default=[],
                        help="alignment parameter (readalprm letters), "
                             "e.g. -y w150 -y 'I\"20 800 ...\"'")
        sp.add_argument("-L", dest="lcl", default=None,
                        help="end-gap mode (spaln -L): S = Smith-"
                             "Waterman local; digits = algmode.lcl "
                             "bitmask (16 = local); default 15 "
                             "(semi-global; protein mapping defaults "
                             "to local, the reference recipe)")
        sp.add_argument("-Q", dest="qlevel", type=int, default=7,
                        help="algorithm level (spaln -Q): q&3 = seed "
                             "recursion depth, q>>2 = use block index")
        sp.add_argument("-A", dest="engine", type=int, default=None,
                        help="engine select (spaln -A role): 1 scan "
                             "(linear-space UDH only past the -V plane "
                             "budget, the default), 3 linear-space UDH "
                             "for every multi-slab bucket")
        sp.add_argument("-V", dest="vmf_budget", default=None,
                        help="traceback-plane memory budget with k/M/G "
                             "suffix (MaxVmfSpace role, vmf.h:26-28)")
        sp.add_argument("-G", dest="g_segment", default=None,
                        help="genomic segment length with k/M suffix "
                             "(g_segment chunking)")
        sp.add_argument("-u", dest="u_pen", default=None,
                        help="gap-extension penalty (alprm.u)")
        sp.add_argument("-v", dest="v_pen", default=None,
                        help="gap-open penalty (alprm.v)")
        sp.add_argument("-w", dest="w_band", default=None,
                        help="band width sh (alprm.sh)")
        sp.add_argument("-p", dest="p_flags", action="append",
                        default=[],
                        help="output subflags; q (quiet) accepted for "
                             "reference command-line compatibility")

    sp = sub.add_parser("align", help="align queries to genomic segments")
    sp.add_argument("genomic")
    sp.add_argument("queries")
    common(sp)
    sp.set_defaults(func=cmd_align)

    sp = sub.add_parser("index", help="format genome + build block index")
    sp.add_argument("genome")
    sp.add_argument("-p", dest="prefix", default=None)
    sp.add_argument("-K", dest="kind", default="D",
                    help="index kind(s): D = nt queries (.bkn), "
                         "P = protein queries (.bkp); e.g. -K DP")
    sp.add_argument("--nalpha", type=int, default=20,
                    help="protein reduced alphabet size (6..20, SEB6..)")
    sp.add_argument("--min-orf", type=int, default=30,
                    help="-KP ORF filter in nt (0 disables)")
    sp.set_defaults(func=cmd_index)

    sp = sub.add_parser("map", help="map queries onto an indexed genome")
    sp.add_argument("queries")
    sp.add_argument("-d", dest="genome_db", required=True)
    sp.add_argument("-M", dest="max_out", type=int, default=1,
                    help="report up to M loci per query (paralogs)")
    sp.add_argument("--batch", type=int, default=32,
                    help="queries per device launch (cDNA path)")
    common(sp)
    sp.set_defaults(func=cmd_map)

    sp = sub.add_parser("search",
                        help="protein query vs protein DB (-a mode)")
    sp.add_argument("queries")
    sp.add_argument("-a", dest="db", required=True,
                    help="protein DB fasta")
    sp.add_argument("--max-hits", dest="max_hits", type=int, default=10)
    sp.add_argument("--align-top", dest="align_top", type=int, default=1)
    common(sp)
    sp.set_defaults(func=cmd_search)

    sp = sub.add_parser("sortgrcd",
                        help="merge/cluster/filter -O12 run shards")
    sp.add_argument("shards", nargs="+")
    sp.add_argument("-O", dest="fmt", default="0",
                    help="0 locus report, 15 unique introns")
    sp.add_argument("-F", dest="filter", type=int, default=0,
                    help="filter preset 0..3 (sortgrcd.cc:56-64)")
    sp.add_argument("-C", dest="min_coverage", type=float, default=None)
    sp.add_argument("-I", dest="min_identity", type=float, default=None)
    sp.add_argument("-H", dest="min_score", type=float, default=None,
                    help="min gene score (Gscore)")
    sp.add_argument("-m", dest="bmmc", type=int, default=None,
                    help="max boundary mismatches per terminal exon")
    sp.add_argument("-u", dest="bunp", type=int, default=None,
                    help="max boundary unpaired per terminal exon")
    sp.add_argument("-n", dest="ncan", type=int, default=None,
                    help="terminal-junction canonicity level 0..3")
    sp.add_argument("-S", dest="sort_order", default="a",
                    choices=["a", "b", "c", "r"],
                    help="chromosome order: alphabetic/abundance/"
                         "appearance/reverse-minus")
    sp.add_argument("-o", dest="output", default=None)
    sp.set_defaults(func=cmd_sortgrcd)

    sp = sub.add_parser("pair", help="align paired entries "
                        "(two parallel files, or one alternating file)")
    sp.add_argument("a")
    sp.add_argument("b", nargs="?", default=None)
    sp.add_argument("--mode", default="auto",
                    choices=["auto", "para", "altr", "grup", "every",
                             "fvso", "self"],
                    help="input pairing mode (SeqServer IM_*)")
    sp.add_argument("--split", type=int, default=1,
                    help="grup mode: size of group 1")
    sp.add_argument("-O", dest="fmt", default="0")
    sp.add_argument("-o", dest="output", default=None)
    sp.add_argument("-T", dest="species", default=None)
    sp.add_argument("-t", dest="table_dir", default=None)
    sp.add_argument("--lanes", type=int, default=64)
    sp.set_defaults(func=cmd_pair)

    sp = sub.add_parser("ild", help="intron-length-distribution tools "
                        "(fitild / compild / decompild / plotild)")
    sp.add_argument("op", choices=["fit", "compare", "decompose", "plot"])
    sp.add_argument("files", nargs="+",
                    help="length lists (one per line) or saved fits")
    sp.add_argument("-m", dest="modes", type=int, default=2,
                    help="Frechet mixture components (1-3)")
    sp.add_argument("--x-max", type=int, default=20000)
    sp.add_argument("-o", dest="output", default=None)
    sp.set_defaults(func=cmd_ild)

    sp = sub.add_parser("seq", help="sequence toolbox (utn equivalents)")
    sp.add_argument("op", choices=["orf", "polya", "comp", "mutate",
                                   "forge", "resite", "extcds"])
    sp.add_argument("input", nargs="?", default=None)
    sp.add_argument("-o", dest="output", default=None)
    sp.add_argument("-t", dest="table_dir", default=None)
    sp.add_argument("--min-orf", type=int, default=30)
    sp.add_argument("--sub", type=float, default=0.0)
    sp.add_argument("--ins", type=float, default=0.0)
    sp.add_argument("--del", dest="dele", type=float, default=0.0)
    sp.add_argument("--count", type=int, default=1)
    sp.add_argument("--length", type=int, default=1000)
    sp.add_argument("--aa", action="store_true")
    sp.add_argument("--seed", type=int, default=None)
    sp.add_argument("--enzymes", default=None,
                    help="renzyme table path (default: table dir)")
    sp.add_argument("--unique", action="store_true",
                    help="unique-cutter enzymes only")
    sp.set_defaults(func=cmd_seq)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.jaxcache import enable_compile_cache
    enable_compile_cache()
    rc = args.func(args)
    if getattr(args, "metrics", False):
        from .utils.metrics import metrics
        print(metrics.report(), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

