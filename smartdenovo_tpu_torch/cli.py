"""Command-line interface of the port: the subcommands of `sdtpu`.

  python -m smartdenovo_tpu_torch.cli asm reads.fa -p PFX [-e zmo] [-c 1]
                                                  smartdenovo.pl, dmo or zmo
  python -m smartdenovo_tpu_torch.cli zmo -i reads.fa -o out.ovl [-e sw [-n]]
                                                  wtzmo, dot-matrix or SW engine
  python -m smartdenovo_tpu_torch.cli cns -i PFX.dmo.lay -o PFX.cns  wtcns [-a x.aln -V 2.05]
  ... mer | idx | pairaln | cyc | dif | dotplot     the device tools
  ... pre | clp | lay | fq2fa | n50 | dbmidx | dbmget | haplo   host only

The subcommands that run device code take --device (default cuda); a
CUDA device that is not there is an error, never a silent run on the
CPU.  The host-only ones take none.  Stage files keep the reference
formats (17-col .ovl, clip mask TSV, .lay/.utg layout).
"""

from __future__ import annotations

import argparse
import sys
import time

from .utils.log import log


def _add_pre(sub):
    q = sub.add_parser("pre", help="preprocess reads (wtpre)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-o", "--output", default="-")
    q.add_argument("-J", "--min-len", type=int, default=0)
    q.add_argument("-c", "--clip", type=int, default=0)
    q.add_argument("-L", "--keep-all", action="store_true")
    q.add_argument("-p", "--prefix", default="pb")


def _add_zmo(sub):
    q = sub.add_parser("zmo", help="all-vs-all overlap (wtzmo)")
    q.add_argument("-i", "--input", required=True, nargs="+")
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-k", "--ksize", type=int, default=16)
    q.add_argument("-z", "--zsize", type=int, default=10)
    q.add_argument("-Z", "--zmax", type=int, default=16)
    q.add_argument("-m", "--min-id", type=float, default=0.1)
    q.add_argument("-s", "--min-score", type=int, default=200)
    q.add_argument("-A", "--ncand", type=int, default=1000)
    q.add_argument("-J", "--min-len", type=int, default=0)
    q.add_argument("-G", "--gparts", type=int, default=1,
                   help="build the kmer index in G read-block passes to "
                        "cap index memory (reference -G)")
    q.add_argument("-n", "--refine", action="store_true",
                   help="refine each SW hit's alignment (reference -n)")
    q.add_argument("-e", "--engine", choices=("dm", "sw"), default="dm")
    q.add_argument("--batch-q", type=int, default=64)
    q.add_argument("-P", "--parts", type=int, default=1)
    q.add_argument("-p", "--part", type=int, default=0)
    q.add_argument("--device", default="cuda")


def _add_clp(sub):
    q = sub.add_parser("clp", help="clip reads (wtclp)")
    q.add_argument("-i", "--input", required=True, nargs="+")
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-d", "--min-dep", type=int, default=3)
    q.add_argument("-k", "--bin-size", type=int, default=50)
    q.add_argument("-m", "--min-id", type=float, default=0.6)
    q.add_argument("-F", "--whole", action="store_true")
    q.add_argument("-T", "--block-test", action="store_true")


def _add_lay(sub):
    q = sub.add_parser("lay", help="layout unitigs (wtlay)")
    q.add_argument("-i", "--reads", required=True, nargs="+")
    q.add_argument("-j", "--overlaps", required=True, nargs="+")
    q.add_argument("-b", "--clips", default=None)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-s", "--min-score", type=int, default=200)
    q.add_argument("-m", "--min-id", type=float, default=0.1)
    q.add_argument("-w", "--margin", type=int, default=300)
    q.add_argument("-r", "--best-score-cutoff", type=float, default=0.95)
    q.add_argument("-c", "--edgecov", type=int, default=1)
    q.add_argument("-g", "--dot", action="store_true",
                   help="write {output}.{N}.dot graphviz dumps at each "
                        "'g' phase (wtlay print_dot_strgraph)")


def _add_mer(sub):
    q = sub.add_parser("mer", help="k-mer histogram (wtmer)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-k", "--ksize", type=int, default=16)
    q.add_argument("-H", "--no-hz", action="store_true")
    q.add_argument("--device", default="cuda")


def _add_util(sub):
    q = sub.add_parser("n50", help="contiguity stats (seq_n50.pl)")
    q.add_argument("inputs", nargs="+")
    q = sub.add_parser("fq2fa", help="FASTQ -> FASTA (fq2fa.pl)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-o", "--output", default="-")
    q = sub.add_parser("pairaln", help="align two sequences (pairaln)")
    q.add_argument("inputs", nargs="+", help="FASTA with pairs of reads")
    q.add_argument("--device", default="cuda")
    q = sub.add_parser("cyc", help="self-revcomp palindrome mask (wtcyc)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-o", "--output", default="-")
    q.add_argument("-s", "--min-score", type=int, default=400)
    q.add_argument("-m", "--min-id", type=float, default=0.7)
    q.add_argument("--device", default="cuda")
    q = sub.add_parser("dif", help="variants of reads vs first read (wtdif)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("--device", default="cuda")
    q = sub.add_parser("dotplot", help="zmer dot-plot dump for 2 reads "
                                       "(hzm_aln debug_dot_plot)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-o", "--output", default="dot_plot")
    q.add_argument("--device", default="cuda")
    q = sub.add_parser("idx", help="build + snapshot the overlap indexes (wtidx)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-o", "--output", required=True)
    q.add_argument("--device", default="cuda")
    q = sub.add_parser("dbmidx", help="random-access FASTA store (dbm_index_fa.pl)")
    q.add_argument("fasta")
    q = sub.add_parser("dbmget", help="fetch reads from a dbm store "
                                      "(dbm_read_fa.pl; tags name[+:b,e])")
    q.add_argument("dbm")
    q.add_argument("tags", nargs="*")
    q = sub.add_parser("haplo", help="haplotype MSA clustering "
                                     "(pbcluster_haplo.pl)")
    q.add_argument("core", help="reference read name in the MSA")
    q.add_argument("msa", help="TSV: name <tab> aligned-seq per line")


def _add_asm(sub):
    q = sub.add_parser("asm", help="full assembly (smartdenovo.pl)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-p", "--prefix", default="wtasm")
    q.add_argument("-e", "--engine", choices=("dmo", "zmo"), default="dmo")
    q.add_argument("-J", "--min-len", type=int, default=5000)
    q.add_argument("-c", "--consensus", type=int, default=0)
    q.add_argument("--cns-engine", choices=("dag", "poa"), default="dag")
    q.add_argument("--batch-q", type=int, default=16)
    q.add_argument("--device", default="cuda")


def _add_cns(sub):
    q = sub.add_parser("cns", help="consensus (wtcns)")
    q.add_argument("-i", "--layout", required=True)
    q.add_argument("-o", "--output", default="-")
    q.add_argument("-n", "--iterations", type=int, default=6)
    q.add_argument("-a", "--aln-out", default=None,
                   help="align reads against final consensus, write here (wtcns -a)")
    q.add_argument("-V", "--vmsa", type=float, default=None,
                   help="variant matrix in -a output; 2.05 = min count 2, "
                        "min freq 0.05 (wtcns -V)")
    q.add_argument("--device", default="cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sdtpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for f in (_add_pre, _add_zmo, _add_clp, _add_lay, _add_cns, _add_mer,
              _add_util, _add_asm):
        f(sub)
    args = ap.parse_args(argv)
    if hasattr(args, "device"):   # the subcommands that run device code
        from .pipeline.zmo import resolve_device

        resolve_device(args.device)   # fail before reading any input

    if args.cmd == "pre":
        from .pipeline.pre import run_pre

        run_pre(args.inputs, args.output, min_len=args.min_len, clip=args.clip,
                longest=not args.keep_all, prefix=args.prefix)
        return 0

    if args.cmd == "zmo":
        from .data.readbank import ReadBank

        from .pipeline.zmo import ZmoParams, overlap_dmo, write_overlaps

        rb = ReadBank.from_fasta(args.input, min_len=args.min_len)
        mk = ZmoParams.zmo if args.engine == "sw" else ZmoParams.dmo
        p = mk(ksize=args.ksize, zsize=args.zsize,
               max_zmer_freq=args.zmax, min_id=args.min_id,
               min_score=args.min_score, ncand=args.ncand,
               batch_q=args.batch_q, gparts=args.gparts, refine=args.refine)
        ovls = overlap_dmo(rb, p, parts=args.parts, part=args.part,
                           device=args.device)
        write_overlaps(args.output, rb, ovls)
        return 0

    if args.cmd == "clp":
        from .graph.clip import ClpParams, run_clp, write_clp

        def records():
            for path in args.input:
                with open(path) as fh:
                    for line in fh:
                        if line.startswith("#"):
                            continue
                        c = line.rstrip("\n").split("\t")
                        if len(c) < 12:
                            continue
                        yield (c[0], int(c[1] == "-"), int(c[2]), int(c[3]), int(c[4]),
                               c[5], int(c[6] == "-"), int(c[7]), int(c[8]), int(c[9]),
                               int(c[10]), float(c[11]))

        p = ClpParams(min_crs_dep=args.min_dep, bin_size=args.bin_size,
                      min_sm=args.min_id, whole=args.whole,
                      block_test=args.block_test)
        clips = run_clp(records(), p)
        write_clp(args.output, clips)
        return 0

    if args.cmd == "lay":
        from .data.readbank import ReadBank
        from .graph.clip import read_clp
        from .graph.stringgraph import LayParams, run_lay
        from .pipeline.zmo import Overlap

        rb = ReadBank.from_fasta(args.reads, use_qual=True)
        if args.clips:
            clips = read_clp(args.clips)
            # whole-read mode: drop zero-length reads
            drop = {n for n, (o, ln) in clips.items() if ln <= 0}
            names = [n for n in rb.names if n not in drop]
            rb = ReadBank(names, [rb.get(rb.name2id[n]).copy() for n in names])
        ovls = []
        for path in args.overlaps:
            with open(path) as fh:
                for line in fh:
                    if line.startswith("#"):
                        continue
                    c = line.rstrip("\n").split("\t")
                    if len(c) < 16:
                        continue
                    i1 = rb.name2id.get(c[0])
                    i2 = rb.name2id.get(c[5])
                    if i1 is None or i2 is None:
                        continue
                    ovls.append(Overlap(
                        rid1=i1, dir1=int(c[1] == "-"), beg1=int(c[3]), end1=int(c[4]),
                        rid2=i2, dir2=int(c[6] == "-"), beg2=int(c[8]), end2=int(c[9]),
                        score=int(c[10]), identity=float(c[11]), mat=int(c[12]),
                        mis=int(c[13]), ins=int(c[14]), dl=int(c[15]), aln=0,
                    ))
        p = LayParams.dmo(min_score=args.min_score, min_id=args.min_id,
                          margin=args.margin,
                          best_score_cutoff=args.best_score_cutoff,
                          edgecov_cutoff=args.edgecov,
                          dot_prefix=args.output if args.dot else "")
        g = run_lay(rb, ovls, p)
        with open(args.output, "w") as lay_fh, open(args.output + ".utg", "w") as utg_fh, \
             open(args.output + ".dup", "w") as dl, open(args.output + ".utg.dup", "w") as du:
            g.output_layout(lay_fh, utg_fh, dl, du, utg_sm=p.utg_sm)
        return 0

    if args.cmd == "mer":
        from .pipeline.mer import run_mer

        run_mer(args.inputs, ksize=args.ksize, hz=not args.no_hz,
                device=args.device)
        return 0

    if args.cmd == "n50":
        from .utils.stats import print_n50

        print_n50(args.inputs)
        return 0

    if args.cmd == "fq2fa":
        from .io.fasta import read_seqs, write_fasta

        out = sys.stdout if args.output == "-" else open(args.output, "w")
        for tag, desc, seq in read_seqs(args.inputs):
            write_fasta(out, tag + desc, seq)
        if out is not sys.stdout:
            out.close()
        return 0

    if args.cmd == "pairaln":
        from .pipeline.aln_tools import run_pairaln

        run_pairaln(args.inputs, device=args.device)
        return 0

    if args.cmd == "cyc":
        from .pipeline.aln_tools import run_cyc

        run_cyc(args.inputs, args.output, min_score=args.min_score,
                min_id=args.min_id, device=args.device)
        return 0

    if args.cmd == "dif":
        from .pipeline.aln_tools import run_dif

        run_dif(args.inputs, device=args.device)
        return 0

    if args.cmd == "dotplot":
        from .pipeline.aln_tools import run_dotplot

        n = run_dotplot(args.inputs, args.output, device=args.device)
        print(f"{n} matches -> {args.output}.fwd.txt / .rev.txt",
              file=sys.stderr)
        return 0

    if args.cmd == "idx":
        from .pipeline.idx import build_and_save_indexes

        build_and_save_indexes(args.inputs, args.output, device=args.device)
        return 0

    if args.cmd == "dbmidx":
        from .utils.dbmfa import dbm_index_fa

        print(dbm_index_fa(args.fasta))
        return 0

    if args.cmd == "dbmget":
        from .utils.dbmfa import dbm_read_fa

        tags = args.tags or [l.strip() for l in sys.stdin if l.strip()]
        dbm_read_fa(args.dbm, tags)
        return 0

    if args.cmd == "haplo":
        from .utils.dbmfa import pbcluster_haplo

        rows = []
        with open(args.msa) as fh:
            for line in fh:
                c = line.split()
                if len(c) >= 2:
                    rows.append((c[0], c[1]))
        pbcluster_haplo(args.core, rows)
        return 0

    if args.cmd == "asm":
        from .data.readbank import ReadBank, decode_f5q, seq_to_codes
        from .io.fasta import read_seqs_qual
        from .pipeline.pre import preprocess

        from .pipeline.driver import assemble_dmo, assemble_zmo, write_outputs
        from .pipeline.zmo import ZmoParams

        names, seqs, quals = [], [], []
        any_q = False
        for rec in preprocess(read_seqs_qual(args.inputs), min_len=args.min_len):
            names.append(rec[0])
            seqs.append(seq_to_codes(rec[1]))
            if len(rec) > 2:
                quals.append(decode_f5q(rec[2], len(rec[1])))
                any_q = True
            else:
                quals.append(None)
        rb = ReadBank(names, seqs, quals=quals if any_q else None)
        if args.engine == "zmo":
            res = assemble_zmo(rb, ZmoParams.zmo(batch_q=args.batch_q),
                               device=args.device)
        else:
            res = assemble_dmo(rb, ZmoParams.dmo(batch_q=args.batch_q),
                               device=args.device)
        pfx = args.prefix + "." + args.engine
        write_outputs(res, pfx)
        if args.consensus:
            from .pipeline.cns import units_from_graph, write_cns

            t0 = time.time()
            units = units_from_graph(res.graph)
            if args.cns_engine == "poa":
                from .pipeline.msa import run_msa

                cns = run_msa(units)
            else:
                from .pipeline.cns import CnsParams, run_cns

                cns = run_cns(units, CnsParams(), device=args.device)
            log("stage cns: %.3fs", time.time() - t0)
            write_cns(pfx + ".cns", cns)
        return 0

    if args.cmd == "cns":
        from .pipeline.cns import CnsParams, parse_lay_file, run_cns, write_cns

        units = parse_lay_file(args.layout)
        t0 = time.time()
        res = run_cns(units, CnsParams(n_iter=args.iterations),
                      aln_path=args.aln_out, vmsa=args.vmsa,
                      device=args.device)
        log("stage cns: %.3fs", time.time() - t0)
        if args.output == "-":
            from .data.readbank import codes_to_seq

            for name, codes in res:
                sys.stdout.write(f">{name} len={len(codes)}\n{codes_to_seq(codes)}\n")
        else:
            write_cns(args.output, res)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
