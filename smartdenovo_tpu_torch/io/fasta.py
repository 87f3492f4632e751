"""FASTA/FASTQ reading and writing (plain or gzip).

Host-side replacement for the reference's file_reader.c FASTA/FASTQ layer
(reference file_reader.c:73-138).  Sequences are yielded as
(name, description, sequence) tuples of str; bases are kept as raw ASCII.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterable, Iterator, TextIO


def _open_text(path: str) -> TextIO:
    if path == "-":
        import sys

        return sys.stdin
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_seqs(paths: str | Iterable[str]) -> Iterator[tuple[str, str, str]]:
    """Yield (tag, description, seq) from one or more FASTA/FASTQ files."""
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        fh = _open_text(path)
        try:
            yield from _read_one(fh)
        finally:
            if fh is not None and path != "-":
                fh.close()


def _read_one(fh: TextIO) -> Iterator[tuple[str, str, str]]:
    first = fh.readline()
    while first and not first.strip():
        first = fh.readline()
    if not first:
        return
    if first.startswith(">"):
        yield from _read_fasta(fh, first)
    elif first.startswith("@"):
        yield from _read_fastq(fh, first)
    else:
        raise ValueError(f"not FASTA/FASTQ input: {first[:40]!r}")


def _split_header(line: str) -> tuple[str, str]:
    header = line[1:].rstrip("\n")
    parts = header.split(None, 1)
    tag = parts[0] if parts else ""
    desc = (" " + parts[1]) if len(parts) > 1 else ""
    return tag, desc


def _read_fasta(fh: TextIO, first: str) -> Iterator[tuple[str, str, str]]:
    tag, desc = _split_header(first)
    chunks: list[str] = []
    for line in fh:
        if line.startswith(">"):
            yield tag, desc, "".join(chunks)
            tag, desc = _split_header(line)
            chunks = []
        else:
            chunks.append(line.strip())
    yield tag, desc, "".join(chunks)


def _read_fastq(fh: TextIO, first: str) -> Iterator[tuple[str, str, str]]:
    line = first
    while line:
        tag, desc = _split_header(line)
        seq = fh.readline().strip()
        fh.readline()  # +
        fh.readline()  # qual
        yield tag, desc, seq
        line = fh.readline()


def read_seqs_qual(paths: str | Iterable[str]):
    """Yield (tag, desc, seq, qual_or_None) — qual kept for FASTQ/f5q.

    f5q files (pbh5tof5q output) are FASTQ whose quality line holds 7 x L
    track characters (reference file_reader.h f5q support, wtcns.c:938).
    """
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        fh = _open_text(path)
        try:
            first = fh.readline()
            while first and not first.strip():
                first = fh.readline()
            if not first:
                continue
            if first.startswith(">"):
                for tag, desc, seq in _read_fasta(fh, first):
                    yield tag, desc, seq, None
            elif first.startswith("@"):
                line = first
                while line:
                    tag, desc = _split_header(line)
                    seq = fh.readline().strip()
                    fh.readline()  # +
                    qual = fh.readline().strip()
                    yield tag, desc, seq, qual or None
                    line = fh.readline()
            else:
                raise ValueError(f"not FASTA/FASTQ input: {first[:40]!r}")
        finally:
            if fh is not None and path != "-":
                fh.close()


def write_fasta(fh: TextIO, name: str, seq: str, width: int = 0) -> None:
    fh.write(f">{name}\n")
    if width <= 0:
        fh.write(seq)
        fh.write("\n")
    else:
        for i in range(0, len(seq), width):
            fh.write(seq[i : i + width])
            fh.write("\n")
