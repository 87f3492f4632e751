"""Read preprocessing stage — equivalent of the reference `wtpre`.

Keeps the longest subread per PacBio well (subread names look like
`movie/zmw/beg_end`; the well key is the name with a trailing `/x_y`
stripped), applies a minimum-length jackknife (-J) and optional end
clipping (-c), and renames reads to `{prefix}%012d`.
cf. reference wtpre.c:44-141 (longest-subread logic :94-129).
"""

from __future__ import annotations

from typing import Iterable, Iterator


def well_key(tag: str) -> str:
    """Strip a trailing `/<digits>_<digits>` subread suffix from a name.

    Mirrors the backwards scan in wtpre.c:99-119: digits, one '_', digits,
    then '/' terminates the suffix; anything else means no suffix.
    """
    size = len(tag)
    f = 0
    while size:
        c = tag[size - 1]
        if c.isdigit():
            size -= 1
        elif c == "_":
            if f:
                break
            size -= 1
            f = 1
        elif c == "/":
            if f == 1:
                size -= 1
                f = 2
            break
        else:
            break
    if size <= 0 or f < 2:
        return tag
    return tag[:size]


def preprocess(
    records: Iterable[tuple[str, str, str]],
    min_len: int = 0,
    clip: int = 0,
    longest: bool = True,
    prefix: str = "pb",
) -> Iterator[tuple[str, str]]:
    """Yield (new_name, seq) preprocessed reads.

    Note the reference compares subreads by *unclipped* length when picking
    the longest in a well (wtpre.c:120 `max = seq->seq.size` after the first
    subread, but `seqlen > max` uses clipped length on updates — we follow
    the dominant path: compare clipped lengths, which is identical when
    clip == 0, the pipeline default).
    """
    idx = 0
    cur_key: str | None = None
    cur_seq = ""
    cur_qual: str | None = None
    for rec in records:
        tag, _desc, seq = rec[0], rec[1], rec[2]
        # optional f5q quality (7 chars/base): clip/carry alongside
        qual = rec[3] if len(rec) > 3 else None
        if qual is not None and len(qual) != 7 * len(seq):
            qual = None
        if clip:
            if qual is not None:
                L = len(seq)
                q = [qual[k * L + clip: (k + 1) * L - clip] for k in range(7)]
                qual = "".join(q)
            seq = seq[clip : len(seq) - clip]
        if len(seq) < min_len:
            continue
        if not longest:
            yield (f"{prefix}{idx:012d}", seq) + ((qual,) if qual else ())
            idx += 1
            continue
        key = well_key(tag)
        if key == cur_key:
            if len(seq) > len(cur_seq):
                cur_seq = seq
                cur_qual = qual
        else:
            if cur_key is not None:
                yield (f"{prefix}{idx:012d}", cur_seq) + (
                    (cur_qual,) if cur_qual else ())
                idx += 1
            cur_key = key
            cur_seq = seq
            cur_qual = qual
    if cur_key is not None:
        yield (f"{prefix}{idx:012d}", cur_seq) + ((cur_qual,) if cur_qual else ())


def run_pre(inputs, output, min_len=0, clip=0, longest=True, prefix="pb"):
    """wtpre: longest-subread-per-well selection (+ f5q passthrough —
    reference longest_pacbio_subreads_f5q.pl)."""
    from ..io.fasta import read_seqs_qual, write_fasta

    import sys

    out = sys.stdout if output == "-" else open(output, "w")
    try:
        n = 0
        for rec in preprocess(
            read_seqs_qual(inputs), min_len=min_len, clip=clip,
            longest=longest, prefix=prefix
        ):
            if len(rec) > 2:          # f5q: keep the 7-track quality line
                out.write(f"@{rec[0]}\n{rec[1]}\n+\n{rec[2]}\n")
            else:
                write_fasta(out, rec[0], rec[1])
            n += 1
        return n
    finally:
        if out is not sys.stdout:
            out.close()
