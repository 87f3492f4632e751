"""Packed long-read store — the TPU-native BaseBank.

The reference keeps reads as a 2-bit packed BaseBank plus a name table
(reference dna.h BaseBank, wtzmo.c:88-92 pbread_t).  Here reads live as a
single concatenated uint8 array of 2-bit codes (A=0 C=1 G=2 T=3) with
offsets, sorted by length descending (the reference sorts query reads the
same way, wtzmo.c:1707-1713).  Batches for device compute are materialised
as padded [B, L] uint8 tensors with PAD=4.
"""

from __future__ import annotations

import numpy as np

PAD = 4  # padding code; real bases are 0..3

_BASE_MAP = np.full(256, 0, dtype=np.uint8)  # unknown chars -> A, like dna.h base_bit_table
for _i, _c in enumerate("ACGT"):
    _BASE_MAP[ord(_c)] = _i
    _BASE_MAP[ord(_c.lower())] = _i

_BIT_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def seq_to_codes(seq: str) -> np.ndarray:
    return _BASE_MAP[np.frombuffer(seq.encode(), dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    return _BIT_BASE[codes].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def decode_f5q(qual: str, length: int) -> np.ndarray:
    """Decode an f5q quality line (7 x L track chars) to [7, L] uint8.

    Tracks 0-4 are phred chars (-33); 5-6 are base letters -> 2-bit codes
    (reference push5q_wtcns, wtcns.c:180-183)."""
    raw = np.frombuffer(qual.encode(), np.uint8).reshape(7, length)
    out = np.empty_like(raw)
    out[:5] = raw[:5] - 33
    out[5:] = _BASE_MAP[raw[5:]]
    return out


def encode_f5q(q: np.ndarray) -> str:
    """Inverse of decode_f5q: [7, L] tracks -> the 7 x L character line."""
    raw = np.empty_like(q)
    raw[:5] = q[:5] + 33
    raw[5:] = _BIT_BASE[np.clip(q[5:], 0, 3)]
    return raw.tobytes().decode()


def revcomp_f5q(q: np.ndarray) -> np.ndarray:
    """Strand-flip f5q tracks: reverse positions, complement tags 5-6
    (reference wtlay.c:2805-2815)."""
    out = q[:, ::-1].copy()
    out[5:] = 3 - np.clip(out[5:], 0, 3)
    return out


class ReadBank:
    """Immutable store of reads, sorted length-descending.

    Attributes:
      names:   list of read names, in sorted (length desc, name asc) order
      lengths: int32 [n] read lengths
      offsets: int64 [n+1] offsets into `bases`
      bases:   uint8 [total] 2-bit base codes
      name2id: dict name -> sorted id
    """

    def __init__(self, names: list[str], seqs: list[np.ndarray], sort: bool = True,
                 quals: list | None = None):
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        if sort:
            # length descending, name ascending for determinism
            order = sorted(range(len(names)), key=lambda i: (-lens[i], names[i]))
        else:
            order = list(range(len(names)))
        self.names = [names[i] for i in order]
        seqs = [seqs[i] for i in order]
        self.lengths = lens[order].astype(np.int32)
        self.offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(self.lengths, out=self.offsets[1:])
        self.bases = (
            np.concatenate(seqs).astype(np.uint8) if seqs else np.zeros(0, dtype=np.uint8)
        )
        self.name2id = {n: i for i, n in enumerate(self.names)}
        # optional f5q tracks: per read [7, L] uint8 (0-4 phred, 5-6 base
        # codes) or None — reference rdqvs (wtcns.c:172-186)
        self.quals = [quals[i] for i in order] if quals else None

    @classmethod
    def from_fasta(cls, paths, min_len: int = 0, sort: bool = True,
                   use_qual: bool = False) -> "ReadBank":
        """Load FASTA/FASTQ; with use_qual, keep f5q 7-track qualities."""
        if use_qual:
            from ..io.fasta import read_seqs_qual

            names, seqs, quals = [], [], []
            any_q = False
            for tag, _desc, seq, qual in read_seqs_qual(paths):
                if len(seq) < min_len:
                    continue
                names.append(tag)
                seqs.append(seq_to_codes(seq))
                if qual is not None and len(qual) == 7 * len(seq):
                    quals.append(decode_f5q(qual, len(seq)))
                    any_q = True
                else:
                    quals.append(None)
            return cls(names, seqs, sort=sort, quals=quals if any_q else None)
        from ..io.fasta import read_seqs

        names, seqs = [], []
        for tag, _desc, seq in read_seqs(paths):
            if len(seq) < min_len:
                continue
            names.append(tag)
            seqs.append(seq_to_codes(seq))
        return cls(names, seqs, sort=sort)

    def __len__(self) -> int:
        return len(self.names)

    @property
    def total_bases(self) -> int:
        return int(self.offsets[-1])

    def get(self, rid: int) -> np.ndarray:
        return self.bases[self.offsets[rid] : self.offsets[rid + 1]]

    def get_seq(self, rid: int) -> str:
        return codes_to_seq(self.get(rid))

    def apply_clips(self, clips: dict[str, tuple[int, int]]) -> "ReadBank":
        """Return a new bank with per-read (offset, length) clips applied.

        Reads absent from `clips` are kept whole; reads clipped to length 0
        are dropped.  cf. reference set_read_clip_wtzmo (wtzmo.c:217-226).
        """
        names, seqs, quals = [], [], []
        for rid, name in enumerate(self.names):
            q = self.quals[rid] if self.quals else None
            if name in clips:
                off, ln = clips[name]
                if ln <= 0:
                    continue
                seqs.append(self.get(rid)[off : off + ln].copy())
                quals.append(q[:, off: off + ln].copy() if q is not None else None)
            else:
                seqs.append(self.get(rid).copy())
                quals.append(q)
            names.append(name)
        return ReadBank(names, seqs,
                        quals=quals if self.quals is not None else None)

    def batch(self, rids: np.ndarray, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Materialise reads `rids` as a padded [B, L] uint8 batch (+ lengths)."""
        rids = np.asarray(rids, dtype=np.int64)
        lens = self.lengths[rids]
        L = int(pad_to if pad_to is not None else (lens.max() if len(lens) else 0))
        out = np.full((len(rids), L), PAD, dtype=np.uint8)
        for i, rid in enumerate(rids):
            n = min(int(lens[i]), L)
            out[i, :n] = self.bases[self.offsets[rid] : self.offsets[rid] + n]
        return out, lens.astype(np.int32)

    def avg_len(self) -> int:
        # cf. wtzmo.c index_wtzmo avg_rdlen computation (:1360-1369)
        if len(self) == 0:
            return 10000
        return max(1, int(self.offsets[-1] // len(self)))
