"""Small alignment tools — equivalents of `pairaln`, `wtcyc`, `wtdif` and
the dot-plot dump (port of smartdenovo_tpu/pipeline/aln_tools.py).

pairaln: align consecutive read pairs from FASTA input and print stats
(reference pairaln.c — a 2-sequence debugging harness).
wtcyc: align each read against its own reverse complement to detect
missed-adapter palindromes; emit a retained-region mask for the longer
half (reference wtcyc.c, README-tools.md:320-335).
wtdif: align reads 2..N to read 1 and print their variants.

The JAX package makes one device call per pair.  Here the pairs of a
length tier (the JAX call's LA, ops/align.py pow2_tier) share one call:
a pair's rows stop at its own alen, padding codes never match and its
band is clipped at its own blen, so each pair's answer is the one its own
call gives, and every output line is the JAX package's.  wtdif aligns
through the batched banded stage (ops/align.py banded_runs).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..data.readbank import revcomp_codes, seq_to_codes
from ..io.fasta import read_seqs
from ..ops.align import banded_runs, pow2_tier, run_lists, tier_chunks
from ..ops.banded import align_strings
from ..ops.overlap_dp import banded_local_dp
from ..utils.native import Segments

# codes (a, b) of one banded_local_dp call at most, summed over its pairs
LOCAL_ELEMS = 1 << 26


def _pad_rows(seqs, width: int) -> np.ndarray:
    out = np.full((len(seqs), width), 4, np.uint8)
    for k, s in enumerate(seqs):
        out[k, :len(s)] = s
    return out


def local_chunks(pairs):
    """The banded_local_dp calls of align_local_batch over pairs: (indices,
    LA), one length tier of a a call, cut under LOCAL_ELEMS codes."""
    def fits(n, LA, lb):
        return n * (LA + max(LA, lb)) <= LOCAL_ELEMS

    return tier_chunks([len(a) for a, _ in pairs], fits,
                       [len(b) for _, b in pairs], tier=pow2_tier)


def local_inputs(pairs, LA: int, device):
    """The seven inputs of banded_local_dp for pairs at LA on device: the
    codes padded to LA and to the longest b (at least LA), the lengths,
    and the band anchored at (0, 0) with slope 1."""
    dev = torch.device(device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    a_s = [a for a, _ in pairs]
    b_s = [b for _, b in pairs]
    LB = max(LA, max(len(s) for s in b_s))
    n = len(pairs)
    return (torch.from_numpy(_pad_rows(a_s, LA)).to(dev),
            torch.from_numpy(_pad_rows(b_s, LB)).to(dev),
            i32([len(s) for s in a_s]), i32([len(s) for s in b_s]),
            i32([0] * n), i32([0] * n), i32([1 << 12] * n))


def align_local_batch(pairs, W: int = 256, *, device="cuda") -> np.ndarray:
    """The JAX package's `_align_two(a, b, W)` for every (a, b) of pairs:
    [n, 4] int64 (score, matches, end in a, end in b), one
    banded_local_dp call per chunk of local_chunks."""
    out = np.zeros((len(pairs), 4), np.int64)
    for idx, LA in local_chunks(pairs):
        res = banded_local_dp(*local_inputs([pairs[k] for k in idx], LA,
                                            device), LA=LA, W=W)
        out[idx] = torch.stack(res, 1).cpu().numpy()
    return out


def run_pairaln(inputs, out=None, *, device="cuda"):
    out = out or sys.stdout
    recs = list(read_seqs(inputs))
    jobs = [(recs[i], recs[i + 1]) for i in range(0, len(recs) - 1, 2)]
    res = align_local_batch([(seq_to_codes(r1[2]), seq_to_codes(r2[2]))
                             for r1, r2 in jobs], device=device)
    for ((n1, _, s1), (n2, _, s2)), (sc, mat, ea, eb) in zip(jobs, res):
        aln = max(ea, eb)
        out.write(f"{n1}\t{len(s1)}\t{n2}\t{len(s2)}\t{sc}\t{mat}\t"
                  f"{mat / max(1, aln):.3f}\n")


def run_cyc(inputs, output="-", min_score: int = 400, min_id: float = 0.7,
            out=None, *, device="cuda"):
    """Detect palindromic (self-revcomp) reads; keep the longer arm.

    Reference semantics (wtcyc.c output_alignment:78-92): align rc(read)
    vs read; if the local alignment scores >= min_score at identity >=
    min_id, touches a read end, and is coordinate-symmetric (an inverted
    repeat maps onto itself: |tb - (len-qe)| < 50 and |te - (len-qb)| <
    50), the fold point is bp = (tb + te) / 2 — the midpoint of the
    palindromic region — and the longer side of bp is kept.  Begin
    coordinates come from a second local DP on the reversed sequences,
    run only for the reads whose first DP scored >= min_score.
    """
    recs = [(name, seq_to_codes(seq)) for name, _, seq in read_seqs(inputs)]
    rcs = [revcomp_codes(codes) for _, codes in recs]
    first = align_local_batch([(rc, codes) for rc, (_, codes)
                               in zip(rcs, recs)], W=1600, device=device)
    hits = [k for k in range(len(recs)) if first[k, 0] >= min_score]
    # suffix trick: ends of the reversed problem are begins
    second = align_local_batch([(rcs[k][::-1].copy(), recs[k][1][::-1].copy())
                                for k in hits], W=1600, device=device)
    ends = dict(zip(hits, second))
    fh = sys.stdout if output == "-" else open(output, "w")
    try:
        for k, (name, codes) in enumerate(recs):
            ln = len(codes)
            sc, mat, qe, te = (int(x) for x in first[k])
            bp = -1
            if sc >= min_score:
                _sc2, _m2, ea2, eb2 = (int(x) for x in ends[k])
                qb = ln - ea2
                tb = ln - eb2
                aln = max(qe - qb, te - tb)
                ident = mat / (aln + 1)
                anchored = tb <= 0 or te >= ln
                symmetric = (abs(tb - (ln - qe)) < 50
                             and abs(te - (ln - qb)) < 50)
                if ident >= min_id and anchored and symmetric:
                    bp = (tb + te) // 2
            if bp >= 0:
                if bp < ln // 2:
                    fh.write(f"{name}\t{bp}\t{ln - bp}\t{ln}\n")
                else:
                    fh.write(f"{name}\t0\t{bp}\t{ln}\n")
            else:
                fh.write(f"{name}\t0\t{ln}\t{ln}\n")
    finally:
        if fh is not sys.stdout:
            fh.close()


def run_dif(inputs, out=None, W: int = 256, *, device="cuda"):
    """wtdif equivalent: align reads 2..N to read 1, report variants.

    Output: qname, pos-on-ref, type(S/I/D), ref base(s), alt base(s).
    The reads align through the batched banded stage at the JAX package's
    LA (pow2_tier), a call per length tier.
    """
    out = out or sys.stdout
    recs = list(read_seqs(inputs))
    if len(recs) < 2:
        return
    ref = seq_to_codes(recs[0][2])
    reads = [(name, seq_to_codes(seq)) for name, _, seq in recs[1:]]
    res = banded_runs(Segments.from_pairs([(c, ref) for _, c in reads]), W,
                      tier=pow2_tier, device=device)
    cigs = run_lists(res.ops, res.counts, res.run_beg, res.run_end)
    bases = "ACGT-"
    lines = []
    for (name, codes), (ops, counts), b_beg in zip(reads, cigs,
                                                   res.b_beg.tolist()):
        ra, rb = align_strings(codes, ref[b_beg:], ops, counts)
        pos = b_beg
        for x, y in zip(ra, rb):
            if y != 4 and x != 4 and x != y:
                lines.append(f"{name}\t{pos}\tS\t{bases[y]}\t{bases[x]}\n")
            elif y == 4 and x != 4:
                lines.append(f"{name}\t{pos}\tI\t-\t{bases[x]}\n")
            elif x == 4 and y != 4:
                lines.append(f"{name}\t{pos}\tD\t{bases[y]}\t-\n")
            if y != 4:
                pos += 1
    out.write("".join(lines))


def run_dotplot(inputs, prefix: str = "dot_plot", zsize: int = 10,
                hz: bool = True, max_zmer_freq: int = 64, *, device="cuda"):
    """Dot-plot debug dump for exactly two reads (reference
    debug_dot_plot_hzmps, hzm_aln.h:902-931): writes
    {prefix}.fwd.txt / {prefix}.rev.txt with one `off1\\toff2` zmer match
    per line — the raw image the dot-matrix aligner chains.  The seeds
    are extracted on `device`."""
    from ..data.readbank import ReadBank
    from ..ops.seeds import extract_seeds

    rb = ReadBank.from_fasta(inputs, sort=False)
    if len(rb) != 2:
        raise ValueError(f"dot plot needs exactly 2 reads, got {len(rb)}")
    dev = torch.device(device)
    batch, lens = rb.batch(np.arange(2))
    res = extract_seeds(torch.from_numpy(batch).to(dev),
                        torch.from_numpy(lens).to(dev), zsize, hz)
    km, off, dr, ok = (res[k].cpu().numpy()
                       for k in ("kmer", "off", "dir", "valid"))
    rows = []
    for i in (0, 1):
        d = {}
        for j in np.nonzero(ok[i])[0]:
            d.setdefault(int(km[i][j]), []).append(
                (int(off[i][j]), int(dr[i][j])))
        rows.append(d)
    n_match = 0
    with open(f"{prefix}.fwd.txt", "w") as fwd, \
         open(f"{prefix}.rev.txt", "w") as rev:
        for z, occ0 in rows[0].items():
            occ1 = rows[1].get(z)
            if occ1 is None or len(occ0) > max_zmer_freq \
                    or len(occ1) > max_zmer_freq:
                continue
            for o0, d0 in occ0:
                for o1, d1 in occ1:
                    out = rev if (d0 ^ d1) else fwd
                    o1p = (int(rb.lengths[1]) - o1 - zsize) if (d0 ^ d1) else o1
                    out.write(f"{o0}\t{o1p}\n")
                    n_match += 1
    return n_match
