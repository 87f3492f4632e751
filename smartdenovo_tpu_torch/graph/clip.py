"""Read clipping / chimera filtering — equivalent of the reference `wtclp`.

Host graph-plane logic (interval sweeps over <=10^6 overlap records);
semantics follow wtclp.c closely:

  - load: per-read forward-strand overlap coordinates (wtclp.c:111-182,
    '-' strand flipped :150-157), identity/length filters
  - call_legal_overlaps (:197-233): margin test against current clips
  - clp_high_err_region (:235-299): keep the longest region with
    overlap depth >= min_dep; contained reads are pinned
  - test_chimera (:565-712, the -T "block path" mode used by the dmo
    pipeline): spur-supported break bins + fine-overlap plea voting
  - filter_lonely (:723-816): reads lacking a legal overlap touching
    the left or right clip edge are dropped.  (The reference's deeper
    BFS collapses to exactly this test — its `pid = h1->sids[d1]`
    re-visits the read itself — so we implement the effective check.)

Output rows match the reference TSV: name, abs_offset, kept_len,
original_len, x, y, closed (wtclp.c:897-911).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.log import log


@dataclasses.dataclass
class ClpParams:
    min_aln_len: int = 1000   # -s
    min_sm: float = 0.6       # -m (dmo: 0.1)
    bin_size: int = 50        # -k (dmo: 300)
    win_size: int = 1000      # -w
    min_crs_dep: int = 3      # -d
    max_iter: int = 5         # -n
    whole: bool = False       # -F : keep full length or drop whole read
    block_test: bool = False  # -T : single-pass chimera block-path test
    fix_contained: bool = True
    debug_x: int = 7

    @classmethod
    def dmo(cls, **kw) -> "ClpParams":
        """dmo pipeline flags: wtclp -d 3 -k 300 -m 0.1 -FT (smartdenovo.pl:52)."""
        d = dict(min_sm=0.1, bin_size=300, whole=True, block_test=True)
        d.update(kw)
        return cls(**d)


class ClipState:
    """Per-read clip state + per-read sorted views of overlap endpoints."""

    def __init__(self):
        self.names: list[str] = []
        self.name2id: dict[str, int] = {}
        self.lens: list[int] = []
        self.obts: list[tuple[int, int]] = []  # (abs offset, original len)
        # hits: each is (sid1, sid2, dir1, dir2, x1, y1, x2, y2)
        self.hits: list[tuple] = []

    def _seq(self, name: str, length: int) -> int:
        sid = self.name2id.get(name)
        if sid is None:
            sid = len(self.names)
            self.name2id[name] = sid
            self.names.append(name)
            self.lens.append(length)
            self.obts.append((0, length))
        return sid

    def set_read_clip(self, name: str, coff: int, clen: int, seqlen: int):
        sid = self.name2id.get(name)
        if sid is None:
            return
        if self.lens[sid] != clen:
            raise ValueError(f"clip length mismatch for {name}")
        self.obts[sid] = (coff, seqlen)


def _flip(dirflag: int, x: int, y: int, length: int) -> tuple[int, int]:
    if dirflag:
        return length - y, length - x
    return x, y


def load_overlaps_clp(records, params: ClpParams) -> ClipState:
    """records: iterables of (name1, dir1, len1, beg1, end1, name2, dir2,
    len2, beg2, end2, score, identity)."""
    st = ClipState()
    for rec in records:
        n1, d1, l1, b1, e1, n2, d2, l2, b2, e2, _score, sm = rec[:12]
        if sm < params.min_sm:
            continue
        x1, y1 = _flip(d1, b1, e1, l1)
        x2, y2 = _flip(d2, b2, e2, l2)
        if x1 + params.min_aln_len > y1 or x2 + params.min_aln_len > y2:
            continue
        s1 = st._seq(n1, l1)
        s2 = st._seq(n2, l2)
        st.hits.append((s1, s2, d1, d2, x1, y1, x2, y2))
    return st


class _Arrays:
    """Columnar view of hits + per-read ptr lists sorted by start coord."""

    def __init__(self, st: ClipState):
        n = len(st.names)
        h = np.array(st.hits, dtype=np.int64).reshape(-1, 8)
        self.s = h[:, 0:2]
        self.d = h[:, 2:4]
        self.x = h[:, 4:8:2]  # x1, x2
        self.y = h[:, 5:8:2]  # y1, y2
        self.legal = np.zeros(len(h), bool)
        self.lens = np.array(st.lens, dtype=np.int64)
        self.clp = np.stack([np.zeros(n, np.int64), self.lens.copy()], axis=1)
        self.fix = np.zeros(n, bool)
        self.closed = np.zeros(n, np.int8)
        # per-read sorted (hit, side) lists
        self.ptrs: list[list[tuple[int, int]]] = [[] for _ in range(n)]
        for i in range(len(h)):
            self.ptrs[self.s[i, 0]].append((i, 0))
            self.ptrs[self.s[i, 1]].append((i, 1))
        for sid in range(n):
            self.ptrs[sid].sort(key=lambda t: self.x[t[0], t[1]])


def call_legal_overlaps(a: _Arrays, p: ClpParams) -> int:
    """wtclp.c:197-233."""
    ret = 0
    bs = p.bin_size
    a.fix[:] = False
    for i in range(len(a.legal)):
        s1, s2 = a.s[i]
        if a.closed[s1] and a.closed[s2]:
            a.legal[i] = False
            continue
        d0 = int(a.clp[s1, 0] - a.x[i, 0])
        d1 = int(a.y[i, 0] - a.clp[s1, 1])
        d2 = int(a.clp[s2, 0] - a.x[i, 1])
        d3 = int(a.y[i, 1] - a.clp[s2, 1])
        if p.fix_contained:
            if d0 + bs > 0 and d1 + bs > 0:
                a.fix[s1] = True
            if d2 + bs > 0 and d3 + bs > 0:
                a.fix[s2] = True
        if a.d[i, 0] != a.d[i, 1]:
            sa = max(d0, d3)
            sb = max(d1, d2)
        else:
            sa = max(d0, d2)
            sb = max(d1, d3)
        if sa + bs < 0 or sb + bs < 0:
            a.legal[i] = False
            continue
        sa = max(sa, 0)
        sb = max(sb, 0)
        if sa + sb + p.min_aln_len > bs + int(a.y[i, 0] - a.x[i, 0]):
            a.legal[i] = False
            continue
        a.legal[i] = True
        ret += 1
    return ret


def clp_high_err_region(a: _Arrays, p: ClpParams, min_dep: int, whole: bool):
    """wtclp.c:235-299."""
    bs = p.bin_size
    for sid in range(len(a.lens)):
        if a.closed[sid]:
            continue
        brks = []
        fix = False
        for (i, k) in a.ptrs[sid]:
            if not a.legal[i]:
                continue
            if p.fix_contained and a.x[i, k] < bs and a.y[i, k] + bs > a.lens[sid]:
                fix = True
            brks.append((int(a.x[i, k]), 0))
            brks.append((int(a.y[i, k]), 1))
        if not brks:
            a.clp[sid] = (0, 0)
            a.closed[sid] = 3
            continue
        brks.sort(key=lambda t: t[0])
        if fix:
            a.fix[sid] = True
            if not whole:
                a.clp[sid] = (brks[0][0], brks[-1][0])
            continue
        dep = mx = my = xx = 0
        best = 0
        for pos, isend in brks:
            if dep >= min_dep:
                if pos - xx > best:
                    best = pos - xx
                    mx, my = xx, pos
            if isend:
                dep -= 1
            else:
                dep += 1
                if dep == min_dep:
                    xx = pos
        if whole:
            if mx > bs or a.lens[sid] - my > bs:
                a.clp[sid] = (0, 0)
                a.closed[sid] = 3
        else:
            a.clp[sid] = (mx, my)


def test_chimera_one(a: _Arrays, p: ClpParams, sid: int) -> int:
    """wtclp.c:565-712 (-T block-path chimera test)."""
    if p.min_crs_dep == 0 or a.closed[sid]:
        return 0
    cx, cy = int(a.clp[sid, 0]), int(a.clp[sid, 1])
    if cx >= cy:
        return 0
    bs = p.bin_size
    fine = []   # (pos_bin, end_bin)
    crss = []   # (pos_bin, dir, spur_bin)
    for (i, k) in a.ptrs[sid]:
        x, y = int(a.x[i, k]), int(a.y[i, k])
        d0 = x - cx
        d1 = cy - y
        d2 = int(a.x[i, 1 - k])
        d3 = int(a.lens[a.s[i, 1 - k]] - a.y[i, 1 - k])
        if a.d[i, 0] != a.d[i, 1]:
            d2, d3 = d3, d2
        xs = d0 > bs and d2 > bs
        ys = d1 > bs and d3 > bs
        if xs:
            crss.append((x // bs, 0, min(y, cy) // bs))
        if ys:
            crss.append((y // bs, 1, max(x, cx) // bs))
        if not xs and not ys:
            fine.append((x // bs, y // bs))
    if len(crss) < p.min_crs_dep:
        return 0
    crss.sort(key=lambda t: t[0])
    chis = []
    j = 0
    for i in range(1, len(crss) + 1):
        pos = crss[i][0] if i < len(crss) else None
        if pos == crss[j][0]:
            continue
        if i - j >= p.min_crs_dep and crss[j][0] > 0 and crss[j][0] < cy // bs:
            chis.append(crss[j][0])
        j = i
    if not chis:
        return 0
    # fine overlaps voting which break-span they cover
    pleas = []
    for (fx, fy) in fine:
        first = last = -1
        for jj, cpos in enumerate(chis):
            if fx < cpos and fy > cpos:
                if first == -1:
                    first = jj
                last = jj
        if first >= 0:
            pleas.append((first, last))
    ret = 1
    best = -1
    mx = my = 0
    if pleas:
        pleas.sort()
        j = 0
        for i in range(1, len(pleas) + 1):
            cur = pleas[i] if i < len(pleas) else None
            if cur == pleas[j]:
                continue
            if i - j >= p.min_crs_dep:
                first, last = pleas[j]
                x = chis[first - 1] * bs if first else cx
                y = cy if last + 1 >= len(chis) else chis[last + 1] * bs
                ln = y - x
                if ln > best:
                    if first == 0 and last + 1 == len(chis):
                        ret = 0
                    best = ln
                    mx, my = x, y
            j = i
    if best == -1:
        x = max(chis[0] * bs, cx)
        y = min(chis[-1] * bs, cy)
        if x >= cy - y:
            a.clp[sid, 1] = x
        else:
            a.clp[sid, 0] = y
    else:
        a.clp[sid] = (mx, my)
    return ret


def detect_chimera_one(a: _Arrays, p: ClpParams, sid: int) -> int:
    """wtclp.c:301-397 (windowed spur/crossing-depth chimera test)."""
    if p.min_crs_dep == 0 or a.closed[sid] or a.fix[sid]:
        return 0
    cx, cy = int(a.clp[sid, 0]), int(a.clp[sid, 1])
    if cx >= cy:
        return 0
    bs = p.bin_size
    win = p.win_size
    crss = []  # (pos, isend, spur)
    tot_dep = 0
    for (i, k) in a.ptrs[sid]:
        if not a.legal[i]:
            continue
        x, y = int(a.x[i, k]), int(a.y[i, k])
        other = a.s[i, 1 - k]
        d0 = x - cx
        d1 = cy - y
        d2 = int(a.x[i, 1 - k] - a.clp[other, 0])
        d3 = int(a.clp[other, 1] - a.y[i, 1 - k])
        if a.d[i, 0] != a.d[i, 1]:
            d2, d3 = d3, d2
        xs = ys = 0
        if d0 > bs:
            if d2 > bs:
                crss.append((x, 0, 1))
                crss.append((x, 1, 0))
                xs = 2
            else:
                xs = 1
        if d1 > bs:
            if d3 > bs:
                crss.append((y, 0, 0))
                crss.append((y, 1, 1))
                ys = 2
            else:
                ys = 1
        if xs == 2 or ys == 2:
            continue
        tot_dep += y - x
        xx = x + xs * win
        yy = y - ys * win
        if xx > yy:
            continue
        crss.append((xx, 0, 0))
        crss.append((yy, 1, 0))
    chis = []  # (pos, isend, spur, dep)
    crss.sort(key=lambda t: t[0])
    dep = 0
    for pos, isend, spur in crss:
        if isend:
            sdep = dep
            dep -= 1
        else:
            dep += 1
            sdep = dep
        if spur:
            chis.append((pos - win, 0, 0, sdep))
            chis.append((pos - 1, 1, 1, sdep))
            chis.append((pos, 0, 1, sdep))
            chis.append((pos + win, 1, 0, sdep))
    avg_dep = (tot_dep + cy - cx) // (cy - cx + 1)
    if len(chis) < avg_dep:
        return 0
    chis.sort(key=lambda t: t[0])
    dep = 0
    best = 0
    mi = 0
    for i, (pos, isend, spur, sdep) in enumerate(chis):
        if isend:
            if spur and dep >= best and sdep < p.min_crs_dep:
                best = dep
                mi = i
            dep -= 1
        else:
            dep += 1
            if spur and dep >= best and sdep < p.min_crs_dep:
                best = dep
                mi = i
    if best * 2 < avg_dep:
        return 0
    pos, _, _, sdep = chis[mi]
    if sdep >= avg_dep:
        return 0
    if pos <= cx or pos >= cy:
        return 0
    if pos - cx > cy - pos:
        a.clp[sid, 1] = pos
    else:
        a.clp[sid, 0] = pos
    return 1


def filter_lonely(a: _Arrays, p: ClpParams) -> int:
    """Effective semantics of filter_lonely_seqs_wtclp (wtclp.c:723-816)."""
    bs = p.bin_size
    ret = 0
    for sid in range(len(a.lens)):
        if a.closed[sid]:
            continue
        if a.fix[sid]:
            continue
        has_left = has_right = False
        contained = False
        for (i, k) in a.ptrs[sid]:
            if not a.legal[i]:
                continue
            if (
                p.fix_contained
                and a.x[i, k] < bs
                and a.y[i, k] + bs > a.lens[sid]
            ):
                contained = True
                break
            if a.x[i, k] < a.clp[sid, 0] + bs:
                has_left = True
            elif a.y[i, k] + bs > a.clp[sid, 1]:
                has_right = True
        if contained:
            a.fix[sid] = True
            continue
        if not (has_left and has_right):
            a.closed[sid] = 2
            ret += 1
    return ret


def estimate_genome(a: _Arrays, p: ClpParams, max_dep: int = 100):
    """Coverage-histogram genome-size estimate (wtclp.c:819-896).

    For every kept, non-contained read, legal overlap intervals (margins
    within bin_size) are swept into a depth profile; segment lengths
    accumulate into a global depth histogram.  Estimated coverage = modal
    overlap depth + 1 (the read itself); genome = kept bases / coverage.
    Returns (hist [max_dep], total_bases, avg_cov, genome_size).
    """
    bs = p.bin_size
    open_r = a.closed == 0
    keep = open_r & (a.clp[:, 0] < a.clp[:, 1])
    tot = int(np.sum((a.clp[:, 1] - a.clp[:, 0])[keep]))
    rid_ev = []
    pos_ev = []
    del_ev = []
    for k in (0, 1):
        s1 = a.s[:, k]
        s2 = a.s[:, 1 - k]
        ok = keep[s1] & ~a.fix[s1] & open_r[s2]
        d0 = a.clp[s1, 0] - a.x[:, k]
        d1 = a.y[:, k] - a.clp[s1, 1]
        d2 = a.clp[s2, 0] - a.x[:, 1 - k]
        d3 = a.y[:, 1 - k] - a.clp[s2, 1]
        diffdir = a.d[:, 0] != a.d[:, 1]
        sa = np.where(diffdir, np.maximum(d0, d3), np.maximum(d0, d2))
        sb = np.where(diffdir, np.maximum(d1, d2), np.maximum(d1, d3))
        ok &= (sa + bs >= 0) & (sb + bs >= 0)
        sa = np.maximum(sa, 0)
        sb = np.maximum(sb, 0)
        alen = a.y[:, k] - a.x[:, k]
        ok &= sa + sb + bs <= alen
        beg = (a.x[:, k] + sa)[ok]
        end = (a.y[:, k] - sb)[ok]
        rid = s1[ok]
        rid_ev.append(np.concatenate([rid, rid]))
        pos_ev.append(np.concatenate([beg, end]))
        del_ev.append(np.concatenate([np.ones(len(rid), np.int64),
                                      np.full(len(rid), -1, np.int64)]))
    hist = np.zeros(max_dep, np.int64)
    if rid_ev:
        rid = np.concatenate(rid_ev)
        pos = np.concatenate(pos_ev)
        dlt = np.concatenate(del_ev)
        order = np.lexsort((pos, rid))
        rid, pos, dlt = rid[order], pos[order], dlt[order]
        # depth BEFORE each event; segment = [prev_pos, pos) within a read
        dep = np.cumsum(dlt) - dlt
        same = np.concatenate([[False], rid[1:] == rid[:-1]])
        # per-read running depth: subtract the cumsum at each read start
        first_idx = np.nonzero(~same)[0]
        base = np.repeat(dep[first_idx], np.diff(np.append(first_idx, len(rid))))
        dep = dep - base
        seg = np.where(same, pos - np.concatenate([[0], pos[:-1]]), 0)
        sel = (seg > 0) & (dep >= 0) & (dep < max_dep)
        np.add.at(hist, dep[sel], seg[sel])
    if len(hist) > 1 and hist[1:].max() > 0:
        avg = int(np.argmax(hist[1:])) + 1 + 1  # +1 index base, +1 roundup
    else:
        avg = 1
    genome = tot // max(1, avg)
    return hist, tot, avg, genome


def run_clp(records, params: ClpParams | None = None) -> dict[str, tuple[int, int, int, int, int]]:
    """Full wtclp pipeline (main loop wtclp.c:1019-1056).

    Returns name -> (abs_offset, kept_len, orig_len, x, y, closed).
    """
    p = params or ClpParams()
    st = load_overlaps_clp(records, p)
    a = _Arrays(st) if st.hits else None
    out = {}
    if a is None:
        return out
    tol = call_legal_overlaps(a, p)
    log("wtclp: %d reads, %d hits, %d legal", len(st.names), len(st.hits), tol)
    if p.debug_x & 4:
        clp_high_err_region(a, p, p.min_crs_dep, p.whole)
    call_legal_overlaps(a, p)
    max_iter = 1 if p.block_test else p.max_iter
    for it in range(max_iter):
        nflt = filter_lonely(a, p) if (p.debug_x & 2) else 0
        nclp = 0
        if p.debug_x & 1:
            for sid in range(len(a.lens)):
                if a.closed[sid]:
                    continue
                if p.block_test:
                    r = test_chimera_one(a, p, sid)
                else:
                    r = detect_chimera_one(a, p, sid)
                if r:
                    if p.whole:
                        a.closed[sid] = 1
                    nclp += 1
        tol = call_legal_overlaps(a, p)
        log("wtclp iter %d: %d lonely, %d chimeric, %d legal", it + 1, nflt, nclp, tol)
        if nflt + nclp == 0:
            break
    hist, tot, avg, genome = estimate_genome(a, p)
    log("wtclp: %d bp available, est coverage %d, est genome size %d bp",
        tot, avg, genome)
    for sid, name in enumerate(st.names):
        if a.closed[sid]:
            x = y = 0
        else:
            x, y = int(a.clp[sid, 0]), int(a.clp[sid, 1])
        off0, orig = st.obts[sid]
        out[name] = (x + off0, y - x, orig, x, y, int(a.closed[sid]))
    return out


def overlaps_to_clp_records(rb, overlaps):
    """Adapt pipeline Overlap objects to run_clp input tuples."""
    for ov in overlaps:
        yield (
            rb.names[ov.rid1], ov.dir1, int(rb.lengths[ov.rid1]), ov.beg1, ov.end1,
            rb.names[ov.rid2], ov.dir2, int(rb.lengths[ov.rid2]), ov.beg2, ov.end2,
            ov.score, ov.identity,
        )


def write_clp(path: str, clips: dict) -> None:
    with open(path, "w") as fh:
        for name, (o, ln, orig, x, y, closed) in clips.items():
            fh.write(f"{name}\t{o}\t{ln}\t{orig}\t{x}\t{y}\t{closed}\n")


def read_clp(path: str) -> dict[str, tuple[int, int]]:
    """Read a clip mask file: returns name -> (offset, length) for wtlay/wtzmo -b."""
    clips = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            clips[parts[0]] = (int(parts[1]), int(parts[2]))
    return clips
