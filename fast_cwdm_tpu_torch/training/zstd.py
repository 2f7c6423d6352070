"""Zstandard frames (RFC 8878) in numpy: a decoder and a raw-block writer.

tensorstore writes every chunk of an Orbax checkpoint and every node of its
OCDBT store as one zstd frame, and the port may import no zstd package. So
this module decodes what RFC 8878 allows in a frame: raw, RLE and
compressed blocks; literals that are raw, RLE, Huffman-coded in 1 or 4
streams, or treeless (the frame's previous Huffman table); sequences whose
literal-length, offset and match-length codes are predefined, RLE,
FSE-compressed or repeated; the three repeat offsets; frames back to back
and skippable frames; the XXH64 content checksum where the frame carries
one. A dictionary ID raises ``ValueError``, as does any malformed or
truncated frame.

The two loops that carry the cost of a large frame run across blocks in
numpy, one step for all blocks at a time:

* Huffman literals: every stream of every block is a lane with its own
  bit position and its own offset into one flat decoding table; step k
  decodes symbol k of every lane that has one (at most 32 Ki steps, one
  table gather each).
* Sequence execution: every output byte gets a source, a literal's index or
  the output index ``i - offset`` of a match byte; chains of matches
  (overlapping ones included) are resolved by pointer doubling,
  ``src = src[src]`` until every byte points at a literal, in O(log chain)
  gathers.

The FSE state updates of one block's sequences are sequential; they run in
lockstep across blocks. The repeat offsets carry across the blocks of a
frame, so they are resolved in one Python pass over the sequences.

:func:`compress` writes a valid frame of raw blocks, with RLE blocks for
128 KiB blocks of one byte value, and the content size set. It does not
reproduce zstd's compressed bytes: a checkpoint the port writes is larger
on disk than tensorstore's (a documented deviation).
"""

from __future__ import annotations

import functools
import struct

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50  # to 0x184D2A5F
BLOCK_MAX = 1 << 17
_BATCH_BYTES = 1 << 27  # decoded bytes (input bytes where unknown) per numpy pass

# RFC 8878 3.1.1.3.2.1.1: baselines and extra bits of the length codes
_LL_BASE = np.array(list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256,
                                       512, 1024, 2048, 4096, 8192, 16384, 32768, 65536],
                    np.int64)
_LL_BITS = np.array([0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                                13, 14, 15, 16], np.int64)
_ML_BASE = np.array(list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131,
                                          259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
                                          65539], np.int64)
_ML_BITS = np.array([0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                                13, 14, 15, 16], np.int64)
# RFC 8878 3.1.1.3.2.2: predefined distributions (accuracy log, counts)
_LL_DEFAULT = (6, (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                   2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1))
_ML_DEFAULT = (6, (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                   -1, -1, -1, -1, -1))
_OF_DEFAULT = (5, (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                   -1, -1, -1, -1, -1))
# what frame_stats counts per frame
STATS = ("raw_blocks", "rle_blocks", "compressed_blocks", "lit_raw", "lit_rle", "lit_huffman",
         "lit_treeless", "lit_streams1", "lit_streams4", "seq_predefined", "seq_rle",
         "seq_fse", "seq_repeat")
# per code table (LL, OF, ML): largest accuracy log and symbol
_SEQ_LIMITS = ((9, 35), (8, 31), (9, 52))
_HUF_BITS = 11  # longest Huffman code
_WINDOW, _REFILL = 56, 5  # bits a Huffman lane holds; steps between refills (5 * 11 <= 56)

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _fail(msg: str):
    raise ValueError(f"zstd: {msg}")


# ---------------------------------------------------------------------------
# XXH64 (the content checksum)
# ---------------------------------------------------------------------------


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (a zstd frame's checksum is its low 32 bits)."""
    b = bytes(data)
    n, p = len(b), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", b)
        for i in range(0, len(lanes), 4):
            v = [_round(v[0], lanes[i]), _round(v[1], lanes[i + 1]),
                 _round(v[2], lanes[i + 2]), _round(v[3], lanes[i + 3])]
        p = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = (((h ^ _round(0, x)) * _P1) + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, struct.unpack_from("<Q", b, p)[0]), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ ((struct.unpack_from("<I", b, p)[0] * _P1) & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ ((b[p] * _P5) & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def _read_ncount(data: bytes, off: int, end: int, max_log: int, max_sym: int):
    """An FSE table description (RFC 8878 4.1.1) at ``data[off:end]``:
    ``(accuracy_log, normalized counts, bytes used)``."""
    avail = min(end, off + 1024) - off
    x = int.from_bytes(data[off:off + avail], "little")
    al = (x & 15) + 5
    if al > max_log:
        _fail(f"FSE accuracy log {al} above {max_log}")
    bit, remaining, threshold, nbits = 4, (1 << al) + 1, 1 << al, al + 1
    counts: list[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                r = (x >> bit) & 3
                bit += 2
                counts.extend([0] * r)
                if r != 3:
                    break
        top = 2 * threshold - 1 - remaining
        low = (x >> bit) & (threshold - 1)
        if low < top:
            count, bit = low, bit + nbits - 1
        else:
            count = (x >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            bit += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if len(counts) > max_sym + 1 or bit > 8 * avail:
            _fail("corrupt FSE table description")
    if remaining != 1:
        _fail("corrupt FSE table description")
    return al, tuple(counts), (bit + 7) >> 3


@functools.lru_cache(maxsize=4096)
def _fse_table(al: int, counts: tuple):
    """The decoding table of a distribution: per state its symbol, its
    number of bits and its baseline (RFC 8878 4.1.1). Read-only arrays."""
    size = 1 << al
    c = np.array(counts, np.int64)
    syms = np.arange(c.size)
    table = np.zeros(size, np.int64)
    less = syms[c == -1]
    high = size - 1 - less.size
    table[size - 1 - np.arange(less.size)] = less
    step = (size >> 1) + (size >> 3) + 3
    pos = (np.arange(size) * step) & (size - 1)
    pos = pos[pos <= high]
    spread = np.repeat(syms, np.maximum(c, 0))
    if spread.size != pos.size:
        _fail("FSE counts do not fill the table")
    table[pos] = spread
    order = np.argsort(table, kind="stable")
    start = np.searchsorted(table[order], syms)
    rank = np.empty(size, np.int64)
    rank[order] = np.arange(size) - start[table[order]]
    nxt = np.where(c == -1, 1, c)[table] + rank
    nb = al - (np.floor(np.log2(nxt)).astype(np.int64))
    base = (nxt << nb) - size
    out = (table, nb, base)
    for a in out:
        a.flags.writeable = False
    return out


def _rle_table(sym: int):
    z = np.zeros(1, np.int64)
    return (np.array([sym], np.int64), z, z)


def _bits_back(x: int, lo: int, n: int) -> int:
    """``n`` bits of a backward stream ``x`` from bit ``lo`` up; bits below
    the stream's start read as 0."""
    if lo >= 0:
        return (x >> lo) & ((1 << n) - 1)
    hi = lo + n
    return (x & ((1 << hi) - 1)) << -lo if hi > 0 else 0


def _stream_start(last_byte: int, nbytes: int) -> int:
    if last_byte == 0:
        _fail("backward bitstream without its end mark")
    return 8 * (nbytes - 1) + last_byte.bit_length() - 1


def _huffman_weights(data: bytes, p: int, end: int):
    """A Huffman tree description (RFC 8878 4.2.1): ``(weights, bytes)``."""
    if p >= end:
        _fail("truncated Huffman tree description")
    hb = data[p]
    if hb >= 128:
        n = hb - 127
        raw = data[p + 1:p + 1 + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            _fail("truncated Huffman weights")
        w = [v for b in raw for v in (b >> 4, b & 15)][:n]
        return w, 1 + (n + 1) // 2
    if p + 1 + hb > end:
        _fail("truncated Huffman weights")
    al, counts, used = _read_ncount(data, p + 1, p + 1 + hb, 6, 12)
    sym, nb, base = _fse_table(al, counts)
    sym, nb, base = sym.tolist(), nb.tolist(), base.tolist()
    stream = data[p + 1 + used:p + 1 + hb]
    if not stream:
        _fail("empty Huffman weight stream")
    x = int.from_bytes(stream, "little")
    pos = _stream_start(stream[-1], len(stream))
    pos -= al
    s1 = _bits_back(x, pos, al)
    pos -= al
    s2 = _bits_back(x, pos, al)
    if pos < 0:
        _fail("truncated Huffman weight stream")
    w: list[int] = []
    states = [s1, s2]
    k = 0
    while True:
        s = states[k]
        w.append(sym[s])
        pos -= nb[s]
        states[k] = base[s] + _bits_back(x, pos, nb[s])
        k ^= 1
        if pos < 0:
            w.append(sym[states[k]])
            break
        if len(w) > 255:
            _fail("too many Huffman weights")
    return w, 1 + hb


def _huffman_table(weights: list[int]):
    """The decoding table (``symbol | bits << 8`` per peeked 11-bit value),
    from the weights of all symbols but the last."""
    w = np.array(weights, np.int64)
    if w.size > 255 or (w > 12).any():
        _fail("bad Huffman weights")
    total = int(np.sum(np.where(w > 0, 1 << np.maximum(w - 1, 0), 0)))
    if total == 0:
        _fail("bad Huffman weights")
    mb = total.bit_length()
    rest = (1 << mb) - total
    if rest & (rest - 1):
        _fail("Huffman weights do not sum to a power of 2")
    if mb > _HUF_BITS:
        _fail(f"Huffman code length {mb} above {_HUF_BITS}")
    w = np.append(w, rest.bit_length())
    syms = np.arange(w.size)
    used = syms[w > 0]
    order = used[np.lexsort((used, w[used]))]
    entry = order | ((mb + 1 - w[order]) << 8)
    return np.repeat(entry, (1 << (w[order] - 1)) << (_HUF_BITS - mb)).astype(np.int32)


# ---------------------------------------------------------------------------
# Frame parsing: a Python pass over block headers
# ---------------------------------------------------------------------------


class _Plan:
    """What one numpy pass decodes: literal pieces, Huffman lanes, the
    sequence sections of every block, and the output pieces of every
    frame."""

    def __init__(self, data: bytes):
        self.data = data
        self.pool_size = 0
        self.pool_pieces: list[tuple] = []  # ("src", pool, off, n) | ("rle", pool, byte, n)
        self.lanes: list[tuple] = []  # (start, end, nsym, table id, pool offset)
        self.tables: list[np.ndarray] = []
        self.seq_blocks: list[tuple] = []  # (start, end, nseq, (LL, OF, ML) tables)
        self.frames: list[dict] = []

    def pool(self, n: int) -> int:
        off = self.pool_size
        self.pool_size += n
        return off


def _frame_header(data: bytes, p: int):
    if p + 6 > len(data):
        _fail("truncated frame header")
    fhd = data[p + 4]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        _fail("reserved bit set in the frame header")
    q = p + 5
    if not single:
        q += 1  # the window descriptor; the output is decoded whole
    if dict_flag:
        nd = (0, 1, 2, 4)[dict_flag]
        if int.from_bytes(data[q:q + nd], "little"):
            _fail("frames with a dictionary ID are not supported")
        q += nd
    nf = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = None
    if nf:
        if q + nf > len(data):
            _fail("truncated frame header")
        size = int.from_bytes(data[q:q + nf], "little") + (256 if nf == 2 else 0)
        q += nf
    return q, size, bool(checksum)


def _literals(plan: _Plan, p: int, end: int, frame: dict):
    """Parse a literals section: ``(pieces, size, next offset)``; pieces
    are placed in the pool later (or, for Huffman, lanes are made)."""
    data = plan.data
    b0 = data[p]
    kind, sf = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        hl = (1, 2, 1, 3)[sf]
        if p + hl > end:
            _fail("truncated literals header")
        v = int.from_bytes(data[p:p + hl], "little")
        n = v >> 3 if sf in (0, 2) else v >> 4
        q = p + hl
        if kind == 0:
            if q + n > end:
                _fail("truncated raw literals")
            return [("src", q, n)], n, q + n
        if q + 1 > end:
            _fail("truncated RLE literals")
        return [("rle", data[q], n)], n, q + 1
    hl, nbits, nstreams = ((3, 10, 1), (3, 10, 4), (4, 14, 4), (5, 18, 4))[sf]
    if p + hl > end:
        _fail("truncated literals header")
    v = int.from_bytes(data[p:p + hl], "little") >> 4
    n, csize = v & ((1 << nbits) - 1), (v >> nbits) & ((1 << nbits) - 1)
    q, lend = p + hl, p + hl + csize
    if lend > end:
        _fail("literals overrun the block")
    if kind == 2:
        weights, used = _huffman_weights(data, q, lend)
        frame["huffman"] = len(plan.tables)
        plan.tables.append(_huffman_table(weights))
        q += used
    elif frame["huffman"] is None:
        _fail("treeless literals before any Huffman table")
    frame["stats"][f"lit_streams{nstreams}"] += 1
    if nstreams == 1:
        streams = [(q, lend, n)]
    else:
        if q + 6 > lend:
            _fail("truncated jump table")
        s1, s2, s3 = struct.unpack_from("<3H", data, q)
        per = (n + 3) // 4
        a = q + 6
        bounds = [a, a + s1, a + s1 + s2, a + s1 + s2 + s3, lend]
        if bounds[3] > lend or n < 3 * per:
            _fail("bad jump table")
        streams = [(bounds[i], bounds[i + 1], per if i < 3 else n - 3 * per) for i in range(4)]
    return [("huf", streams, frame["huffman"])], n, lend


def _sequences_header(data: bytes, p: int, end: int, frame: dict):
    b0 = data[p]
    if b0 == 0:
        return 0, p + 1, None
    if b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        if p + 2 > end:
            _fail("truncated sequences header")
        nseq, p = ((b0 - 128) << 8) + data[p + 1], p + 2
    else:
        if p + 3 > end:
            _fail("truncated sequences header")
        nseq, p = data[p + 1] + (data[p + 2] << 8) + 0x7F00, p + 3
    if p >= end:
        _fail("truncated sequences header")
    modes = data[p]
    p += 1
    if modes & 3:
        _fail("reserved bits set in the sequence modes")
    tables = []
    for k, (default, shift) in enumerate(((_LL_DEFAULT, 6), (_OF_DEFAULT, 4), (_ML_DEFAULT, 2))):
        mode = (modes >> shift) & 3
        frame["stats"][("seq_predefined", "seq_rle", "seq_fse", "seq_repeat")[mode]] += 1
        if mode == 0:
            t = (default[0], _fse_table(*default))
        elif mode == 1:
            if p >= end:
                _fail("truncated RLE code")
            if data[p] > _SEQ_LIMITS[k][1]:
                _fail("RLE code out of range")
            t = (0, _rle_table(data[p]))
            p += 1
        elif mode == 2:
            al, counts, used = _read_ncount(data, p, end, *_SEQ_LIMITS[k])
            t = (al, _fse_table(al, counts))
            p += used
        else:
            t = frame["seq_tables"][k]
            if t is None:
                _fail("repeat mode before any table")
        frame["seq_tables"][k] = t
        tables.append(t)
    return nseq, p, tables


def _parse_frame(plan: _Plan, p: int) -> int:
    data = plan.data
    q, size, checksum = _frame_header(data, p)
    frame = {"size": size, "checksum": checksum, "blocks": [], "huffman": None,
             "seq_tables": [None, None, None], "has_seq": False,
             "stats": dict.fromkeys(STATS, 0)}
    while True:
        if q + 3 > len(data):
            _fail("truncated block header")
        h = int.from_bytes(data[q:q + 3], "little")
        last, btype, bsize = h & 1, (h >> 1) & 3, h >> 3
        q += 3
        if btype == 3:
            _fail("reserved block type")
        if bsize > BLOCK_MAX and btype != 1:
            _fail("block above 128 KiB")
        if btype == 0:
            if q + bsize > len(data):
                _fail("truncated raw block")
            frame["blocks"].append(("lit", [("src", q, bsize)]))
            frame["stats"]["raw_blocks"] += 1
            q += bsize
        elif btype == 1:
            if q + 1 > len(data):
                _fail("truncated RLE block")
            frame["blocks"].append(("lit", [("rle", data[q], bsize)]))
            frame["stats"]["rle_blocks"] += 1
            q += 1
        else:
            end = q + bsize
            if end > len(data) or bsize == 0:
                _fail("truncated compressed block")
            frame["stats"]["compressed_blocks"] += 1
            if data[q] & 3 == 0:
                frame["stats"]["lit_raw"] += 1
            elif data[q] & 3 == 1:
                frame["stats"]["lit_rle"] += 1
            else:
                frame["stats"]["lit_huffman" if data[q] & 3 == 2 else "lit_treeless"] += 1
            pieces, nlit, r = _literals(plan, q, end, frame)
            if r >= end:
                _fail("block without a sequences section")
            nseq, r, tables = _sequences_header(data, r, end, frame)
            if nseq == 0:
                if r != end:
                    _fail("bytes after an empty sequences section")
                frame["blocks"].append(("lit", pieces))
            else:
                frame["has_seq"] = True
                frame["blocks"].append(("seq", pieces, nlit, len(plan.seq_blocks)))
                plan.seq_blocks.append((r, end, nseq, tables))
            q = end
        if last:
            break
    if checksum:
        if q + 4 > len(data):
            _fail("truncated content checksum")
        frame["digest"] = int.from_bytes(data[q:q + 4], "little")
        q += 4
    plan.frames.append(frame)
    return q


# ---------------------------------------------------------------------------
# The numpy passes
# ---------------------------------------------------------------------------


def _place(plan: _Plan, pieces, frame_in_pool: bool):
    """Give literal pieces pool offsets (Huffman streams become lanes);
    returns the output pieces: ("pool", off, n) or, for raw and RLE data
    outside the pool, themselves."""
    out = []
    for piece in pieces:
        if piece[0] == "huf":
            _, streams, table = piece
            off = plan.pool(sum(s[2] for s in streams))
            o = off
            for start, end, nsym in streams:
                plan.lanes.append((start, end, nsym, table, o))
                o += nsym
            out.append(("pool", off, o - off))
        elif frame_in_pool:
            off = plan.pool(piece[2])
            plan.pool_pieces.append((piece[0], off, piece[1], piece[2]))
            out.append(("pool", off, piece[2]))
        else:
            out.append(piece)
    return out


def _decode_huffman(plan: _Plan, src: np.ndarray, pool: np.ndarray) -> None:
    """Every Huffman stream of the plan in lockstep: step k decodes symbol k
    of every lane that has one.

    The streams are copied side by side into ``packed``, each after 8 zero
    bytes, so that a read below a stream's start gives zeros as RFC 8878
    says. Each lane keeps a 56-bit window of its stream, refilled by one
    unaligned 8-byte gather every ``_REFILL`` steps (each step uses at most
    11 bits); a step peeks the window's top 11 unused bits into the lane's
    table (every table is widened to 11 bits) and uses up the code's
    length. ``top`` is the bit position in ``packed`` of the window's top,
    ``left`` how many of its bits are unused."""
    if not plan.lanes:
        return
    lanes = np.array(plan.lanes, np.int64)
    lanes = lanes[np.argsort(-lanes[:, 2], kind="stable")]
    start, end, nsym, tid, ooff = lanes.T
    if (end <= start).any():
        _fail("empty Huffman stream")
    last = src[end - 1].astype(np.int64)
    if (last == 0).any():
        _fail("Huffman stream without its end mark")
    toff = np.arange(len(plan.tables), dtype=np.int64)[tid] << _HUF_BITS
    flat = np.concatenate(plan.tables).astype(np.int16)
    size = end - start + 8
    base = np.cumsum(size) - size + 8  # each stream's first byte in `packed`
    packed = np.zeros(int(size.sum()) + 8, np.uint8)
    for b, s, e in zip(base.tolist(), start.tolist(), end.tolist()):
        packed[b:b + e - s] = src[s:e]
    words = np.ndarray((packed.size - 7,), "<u8", buffer=packed, strides=(1,))
    top = 8 * (base + end - start - 1) + np.floor(np.log2(last)).astype(np.int64)
    left = np.full(nsym.size, _WINDOW, np.int64)
    window = np.empty(nsym.size, np.int64)
    n_max = int(nsym[0])
    active = nsym.size - np.searchsorted(nsym[::-1], np.arange(n_max), side="right")
    out = np.empty((n_max, nsym.size), np.uint8)
    t, e = np.empty(nsym.size, np.int64), np.empty(nsym.size, np.int16)
    mask = np.uint64((1 << _WINDOW) - 1)
    m = -1
    for k in range(n_max):
        if active[k] != m:
            m = active[k]
            tm, em, om, lm, wm, pm = t[:m], e[:m], toff[:m], left[:m], window[:m], top[:m]
        if k % _REFILL == 0:
            pm += lm - _WINDOW
            lm[:] = _WINDOW
            np.subtract(pm, _WINDOW, out=tm)
            w = words[tm >> 3] >> (tm & 7).astype(np.uint64)
            np.bitwise_and(w, mask, out=w)
            wm[:] = w.view(np.int64)
        np.subtract(lm, _HUF_BITS, out=tm)
        np.right_shift(wm, tm, out=tm)
        np.bitwise_and(tm, (1 << _HUF_BITS) - 1, out=tm)
        np.add(tm, om, out=tm)
        flat.take(tm, out=em)
        out[k, :m] = em
        np.right_shift(em, 8, out=em)
        np.subtract(lm, em, out=lm)
    if (top + left - _WINDOW != 8 * base).any():
        _fail("corrupt Huffman stream")
    rows = np.empty((nsym.size, n_max), np.uint8)  # lane-major, by blocks of steps
    for i in range(0, n_max, 512):
        rows[:, i:i + 512] = out[i:i + 512].T
    for row, o, n in zip(rows, ooff.tolist(), nsym.tolist()):
        pool[o:o + n] = row[:n]


def _ramp(counts: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, s + c) for s, c in zip(starts, counts)])``."""
    return np.repeat(starts - (np.cumsum(counts) - counts), counts) + np.arange(int(counts.sum()))


def _decode_sequences(plan: _Plan, src: np.ndarray):
    """The (literal length, match length, offset value) of every sequence,
    all blocks in lockstep; per block a slice of the three arrays."""
    blocks = plan.seq_blocks
    nblk = len(blocks)
    nseq = np.array([b[2] for b in blocks], np.int64)
    first = np.concatenate([[0], np.cumsum(nseq)[:-1]])
    ll = np.zeros(int(nseq.sum()), np.int64)
    ml, ofv = ll.copy(), ll.copy()
    if not nblk:
        return ll, ml, ofv, first, nseq
    order = np.argsort(-nseq, kind="stable")
    starts = np.array([b[0] for b in blocks], np.int64)[order]
    ends = np.array([b[1] for b in blocks], np.int64)[order]
    last = src[ends - 1].astype(np.int64)
    if (last == 0).any():
        _fail("sequence stream without its end mark")
    # the streams side by side, then a 6-byte little-endian word at every
    # byte offset: a read takes at most 31 + 7 bits
    size = ends - starts
    base = np.cumsum(size) - size
    packed = np.zeros(int(size.sum()) + 5, np.uint8)
    packed[:-5] = src[_ramp(size, starts)]
    w = np.zeros(packed.size - 5, np.int64)
    for i in range(6):
        w |= packed[i:i + w.size].astype(np.int64) << (8 * i)
    # absolute bit position (in `packed`) above the next field of each lane
    pos = 8 * (base + size - 1) + np.floor(np.log2(last)).astype(np.int64)
    floor = 8 * base
    # flat FSE tables: every (block, kind) table gets an offset
    tabs, offs = {}, []
    syms, nbs, bases = [], [], []
    total = 0
    for i in order:
        row = []
        for al, t in blocks[i][3]:
            key = id(t[0])
            if key not in tabs:
                tabs[key] = total
                syms.append(t[0]), nbs.append(t[1]), bases.append(t[2])
                total += t[0].size
            row.append((tabs[key], al))
        offs.append(row)
    sym_f, nb_f, base_f = (np.concatenate(a) for a in (syms, nbs, bases))
    toff = np.array([[o for o, _ in r] for r in offs], np.int64)  # (blocks, 3)
    tal = np.array([[a for _, a in r] for r in offs], np.int64)

    def take(m, n):
        pm = pos[:m]
        pm -= n
        a = np.maximum(pm, floor[:m])
        return (w[a >> 3] >> (a & 7)) & ((1 << n) - 1)

    state = np.zeros((nblk, 3), np.int64)
    for k in range(3):  # LL, OF, ML states in that order
        state[:, k] = toff[:, k] + take(nblk, tal[:, k])
    if (pos < floor).any():
        _fail("truncated sequence stream")
    nseq_o = nseq[order]
    first_o = first[order]
    n_max = int(nseq_o[0])
    active = nblk - np.searchsorted(nseq_o[::-1], np.arange(n_max + 1), side="right")
    for k in range(n_max):
        m = active[k]
        st = state[:m]
        llc, ofc, mlc = sym_f[st[:, 0]], sym_f[st[:, 1]], sym_f[st[:, 2]]
        o = (1 << ofc) + take(m, ofc)
        mlen = _ML_BASE[mlc] + take(m, _ML_BITS[mlc])
        llen = _LL_BASE[llc] + take(m, _LL_BITS[llc])
        idx = first_o[:m] + k
        ofv[idx], ml[idx], ll[idx] = o, mlen, llen
        m2 = active[k + 1]
        if m2:
            st = state[:m2]
            for j in (0, 2, 1):  # update LL, ML, OF in that order
                s = st[:, j]
                st[:, j] = toff[:m2, j] + base_f[s] + take(m2, nb_f[s])
        if (pos[:m] < floor[:m]).any():
            _fail("truncated sequence stream")
    if (pos != floor).any():
        _fail("corrupt sequence stream")
    return ll, ml, ofv, first, nseq


def _resolve_offsets(ll: list[int], ofv: list[int], rep: list[int]) -> list[int]:
    """Offsets from offset values and the repeat offsets (RFC 8878
    3.1.1.5), updating ``rep`` in place."""
    out = []
    r1, r2, r3 = rep
    for lit, v in zip(ll, ofv):
        if v > 3:
            off = v - 3
            r1, r2, r3 = off, r1, r2
        else:
            if lit == 0:
                v += 1
            if v == 1:
                off = r1
            elif v == 2:
                off, r1, r2 = r2, r2, r1
            elif v == 3:
                off, r1, r2, r3 = r3, r3, r1, r2
            else:
                off = r1 - 1
                if off == 0:
                    _fail("zero offset")
                r1, r2, r3 = off, r1, r2
        out.append(off)
    rep[:] = [r1, r2, r3]
    return out


def _decode(data: bytes) -> tuple[list[np.ndarray], list[int]]:
    """Every frame of ``data`` (skippable frames skipped): its output and
    its offset in ``data``, in batches of about ``_BATCH_BYTES`` output."""
    outs: list[np.ndarray] = []
    starts: list[int] = []
    p = 0
    while p < len(data):
        plan = _Plan(data)
        decoded = 0
        while p < len(data) and decoded < _BATCH_BYTES:
            if p + 4 > len(data):
                _fail("truncated frame magic")
            magic = int.from_bytes(data[p:p + 4], "little")
            if magic & 0xFFFFFFF0 == _SKIPPABLE:
                if p + 8 > len(data):
                    _fail("truncated skippable frame")
                p += 8 + int.from_bytes(data[p + 4:p + 8], "little")
                if p > len(data):
                    _fail("truncated skippable frame")
                continue
            if magic != MAGIC:
                _fail(f"bad magic {magic:#010x}")
            starts.append(p)
            q, p = p, _parse_frame(plan, p)
            decoded += plan.frames[-1]["size"] or p - q  # the input size if unknown
        outs.extend(_run(plan))
    return outs, starts


def _decode_checked(data: bytes) -> tuple[list[np.ndarray], list[int]]:
    """:func:`_decode`, every fault of a corrupt input as ``ValueError``."""
    try:
        return _decode(data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"zstd: corrupt frame ({e})") from e


def decompress_many(buffers) -> list[np.ndarray]:
    """The content of each buffer (its frames joined), decoded together:
    one numpy pass covers the blocks of many small buffers."""
    ends = np.cumsum([len(b) for b in buffers])
    outs, starts = _decode_checked(b"".join(buffers))
    owner = np.searchsorted(ends, starts, side="right")
    parts: list[list[np.ndarray]] = [[] for _ in buffers]
    for o, i in zip(outs, owner.tolist()):
        parts[i].append(o)
    return [p[0] if len(p) == 1 else np.concatenate(p) if p else np.empty(0, np.uint8)
            for p in parts]


def _run(plan: _Plan) -> list[np.ndarray]:
    src = np.frombuffer(plan.data, np.uint8)
    for frame in plan.frames:
        frame["pieces"] = [(b[0], _place(plan, b[1], frame["has_seq"]), *b[2:])
                           for b in frame["blocks"]]
    pool = np.empty(plan.pool_size, np.uint8)
    for kind, off, a, n in plan.pool_pieces:
        if kind == "src":
            pool[off:off + n] = src[a:a + n]
        else:
            pool[off:off + n] = a
    _decode_huffman(plan, src, pool)
    seqs = _decode_sequences(plan, src)
    outs = []
    for frame in plan.frames:
        if frame["has_seq"]:
            out = _execute(frame, pool, seqs)
        else:
            parts = []
            for _, pieces in frame["pieces"]:
                for kind, a, n in pieces:
                    if kind == "pool":
                        parts.append(pool[a:a + n])
                    elif kind == "src":
                        parts.append(src[a:a + n])
                    else:
                        parts.append(np.full(n, a, np.uint8))
            out = np.concatenate(parts) if parts else np.empty(0, np.uint8)
        if frame["size"] is not None and out.size != frame["size"]:
            _fail(f"frame decodes to {out.size} bytes, its header says {frame['size']}")
        if frame["checksum"] and xxh64(out) & 0xFFFFFFFF != frame["digest"]:
            _fail("content checksum mismatch")
        outs.append(out)
    return outs


def _execute(frame: dict, pool: np.ndarray, seqs) -> np.ndarray:
    """A frame with sequences: every output byte's source by runs (a
    literal run points into the pool, a match run ``lpool`` past it at the
    output), then match chains resolved by pointer doubling."""
    ll, ml, ofv, first, nseq = seqs
    lpool = pool.size
    lens, params, matches = [], [], []
    rep = [1, 4, 8]
    for piece in frame["pieces"]:
        if piece[0] == "lit":
            for _, off, n in piece[1]:
                lens.append([n]), params.append([off]), matches.append([False])
            continue
        _, ((_, loff, _),), nlit, b = piece
        s = slice(int(first[b]), int(first[b] + nseq[b]))
        lb, mb = ll[s], ml[s]
        offs = _resolve_offsets(lb.tolist(), ofv[s].tolist(), rep)
        used = int(lb.sum())
        if used > nlit:
            _fail("sequences use more literals than the block has")
        m = lb.size
        ln = np.empty(2 * m + 1, np.int64)
        ln[0:-1:2], ln[1:-1:2], ln[-1] = lb, mb, nlit - used
        pr = np.empty(2 * m + 1, np.int64)
        pr[0:-1:2] = loff + np.cumsum(lb) - lb
        pr[1:-1:2], pr[-1] = offs, loff + used
        k = np.zeros(2 * m + 1, bool)
        k[1:-1:2] = True
        lens.append(ln), params.append(pr), matches.append(k)
    length, param, is_match = (np.concatenate(a) for a in (lens, params, matches))
    start = np.cumsum(length) - length
    n = int(length.sum())
    if (is_match & (param > start)).any():
        _fail("match offset beyond the decoded data")
    run_base = np.where(is_match, lpool + start - param, param)
    dtype = np.int32 if lpool + n < 2**31 else np.int64
    ptr = np.arange(n, dtype=dtype) + np.repeat((run_base - start).astype(dtype), length)
    idx = np.flatnonzero(ptr >= lpool)
    while idx.size:
        ptr[idx] = ptr[ptr[idx] - lpool]
        idx = idx[ptr[idx] >= lpool]
    return pool[ptr]


def decompress(data) -> bytes:
    """The content of every frame in ``data``, joined."""
    return b"".join(o.tobytes() for o in _decode_checked(bytes(data))[0])


def frame_stats(data) -> list[dict]:
    """Per frame, how many of each kind of block, literals section and
    sequence table mode it holds (the keys of ``STATS``); nothing is
    decoded."""
    data = bytes(data)
    plan = _Plan(data)
    p = 0
    while p < len(data):
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            p += 8 + int.from_bytes(data[p + 4:p + 8], "little")
            continue
        p = _parse_frame(plan, p)
    return [f["stats"] for f in plan.frames]


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def compress(data) -> bytes:
    """One frame holding ``data`` in raw blocks of up to 128 KiB, a block
    of one byte value as an RLE block, with the content size in the header
    and no checksum. Any zstd decoder reads it."""
    buf = memoryview(data).cast("B")
    n = len(buf)
    fcs_flag, nf = (0, 1) if n < 256 else (1, 2) if n < 65536 + 256 else (2, 4) if n < 2**32 else (3, 8)
    size = n - 256 if nf == 2 else n
    parts = [struct.pack("<IB", MAGIC, (fcs_flag << 6) | 0x20), size.to_bytes(nf, "little")]
    arr = np.frombuffer(buf, np.uint8)
    for i in range(0, max(n, 1), BLOCK_MAX):
        block = arr[i:i + BLOCK_MAX]
        last = int(i + BLOCK_MAX >= n)
        if block.size > 1 and not (block != block[0]).any():
            parts += [((block.size << 3) | 2 | last).to_bytes(3, "little"), block[:1].tobytes()]
        else:
            parts += [((block.size << 3) | last).to_bytes(3, "little"), buf[i:i + BLOCK_MAX]]
    return b"".join(parts)
