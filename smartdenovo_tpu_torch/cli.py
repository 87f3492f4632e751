"""Command-line interface of the port.

  python -m smartdenovo_tpu_torch.cli asm reads.fa -p PFX [-c 1]  smartdenovo.pl, dmo
  python -m smartdenovo_tpu_torch.cli zmo -i reads.fa -o out.ovl   wtzmo, dot-matrix engine
  python -m smartdenovo_tpu_torch.cli cns -i PFX.dmo.lay -o PFX.cns  wtcns, segment engine

All take --device (default cuda); a CUDA device that is not there is an
error, never a silent run on the CPU.  Stage files keep the reference
formats (17-col .ovl, clip mask TSV, .lay/.utg layout).  The other
subcommands of `sdtpu` are not ported yet and say so.
"""

from __future__ import annotations

import argparse
import sys
import time

from smartdenovo_tpu.utils.log import log

# subcommands of sdtpu that the port does not run yet -> ROADMAP item
_NOT_PORTED = dict.fromkeys(
    ("pre", "clp", "lay", "mer", "n50", "fq2fa", "pairaln", "cyc", "dif",
     "dotplot", "idx", "dbmidx", "dbmget", "haplo"),
    "ROADMAP queue 1 item 11 (side tools)")


def _add_zmo(sub):
    q = sub.add_parser("zmo", help="all-vs-all overlap (wtzmo, dot-matrix)")
    q.add_argument("-i", "--input", required=True, nargs="+")
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-k", "--ksize", type=int, default=16)
    q.add_argument("-z", "--zsize", type=int, default=10)
    q.add_argument("-Z", "--zmax", type=int, default=16)
    q.add_argument("-m", "--min-id", type=float, default=0.1)
    q.add_argument("-s", "--min-score", type=int, default=200)
    q.add_argument("-A", "--ncand", type=int, default=1000)
    q.add_argument("-J", "--min-len", type=int, default=0)
    q.add_argument("-G", "--gparts", type=int, default=1)
    q.add_argument("-e", "--engine", choices=("dm", "sw"), default="dm")
    q.add_argument("--batch-q", type=int, default=64)
    q.add_argument("-P", "--parts", type=int, default=1)
    q.add_argument("-p", "--part", type=int, default=0)
    q.add_argument("--device", default="cuda")


def _add_asm(sub):
    q = sub.add_parser("asm", help="full assembly (smartdenovo.pl, dmo)")
    q.add_argument("inputs", nargs="+")
    q.add_argument("-p", "--prefix", default="wtasm")
    q.add_argument("-e", "--engine", choices=("dmo", "zmo"), default="dmo")
    q.add_argument("-J", "--min-len", type=int, default=5000)
    q.add_argument("-c", "--consensus", type=int, default=0)
    q.add_argument("--cns-engine", choices=("dag", "poa"), default="dag")
    q.add_argument("--batch-q", type=int, default=16)
    q.add_argument("--device", default="cuda")


def _add_cns(sub):
    q = sub.add_parser("cns", help="consensus (wtcns, segment engine)")
    q.add_argument("-i", "--layout", required=True)
    q.add_argument("-o", "--output", default="-")
    q.add_argument("-n", "--iterations", type=int, default=6)
    q.add_argument("-a", "--aln-out", default=None,
                   help="final alignments (wtcns -a): not ported yet")
    q.add_argument("-V", "--vmsa", type=float, default=None,
                   help="variant matrix (wtcns -V): not ported yet")
    q.add_argument("--device", default="cuda")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _NOT_PORTED:
        raise NotImplementedError(
            f"subcommand {argv[0]!r} is not ported yet: {_NOT_PORTED[argv[0]]}"
            "; use python -m smartdenovo_tpu.cli")
    ap = argparse.ArgumentParser(prog="sdtpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_zmo(sub)
    _add_asm(sub)
    _add_cns(sub)
    args = ap.parse_args(argv)
    from .pipeline.zmo import resolve_device

    resolve_device(args.device)   # fail before reading any input

    if args.cmd == "zmo":
        from smartdenovo_tpu.data.readbank import ReadBank

        from .pipeline.zmo import ZmoParams, overlap_dmo, write_overlaps

        if args.engine != "dm":
            raise NotImplementedError(
                "zmo -e sw is not ported yet (ROADMAP queue 1 item 9)")
        rb = ReadBank.from_fasta(args.input, min_len=args.min_len)
        p = ZmoParams.dmo(ksize=args.ksize, zsize=args.zsize,
                          max_zmer_freq=args.zmax, min_id=args.min_id,
                          min_score=args.min_score, ncand=args.ncand,
                          batch_q=args.batch_q, gparts=args.gparts)
        ovls = overlap_dmo(rb, p, parts=args.parts, part=args.part,
                           device=args.device)
        write_overlaps(args.output, rb, ovls)
        return 0

    if args.cmd == "asm":
        if args.engine != "dmo":
            raise NotImplementedError(
                "asm -e zmo is not ported yet (ROADMAP queue 1 item 9)")
        from smartdenovo_tpu.data.readbank import ReadBank, decode_f5q, seq_to_codes
        from smartdenovo_tpu.io.fasta import read_seqs_qual
        from smartdenovo_tpu.pipeline.pre import preprocess

        from .pipeline.driver import assemble_dmo, write_outputs
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

        if args.aln_out is not None or args.vmsa is not None:
            raise NotImplementedError(
                "cns -a/-V (final alignments) is not ported yet: they need "
                "the whole-read engine (ROADMAP queue 1 item 10)")
        units = parse_lay_file(args.layout)
        t0 = time.time()
        res = run_cns(units, CnsParams(n_iter=args.iterations),
                      device=args.device)
        log("stage cns: %.3fs", time.time() - t0)
        if args.output == "-":
            from smartdenovo_tpu.data.readbank import codes_to_seq

            for name, codes in res:
                sys.stdout.write(f">{name} len={len(codes)}\n{codes_to_seq(codes)}\n")
        else:
            write_cns(args.output, res)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
