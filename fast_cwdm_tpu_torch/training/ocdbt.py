"""tensorstore's OCDBT key-value store, read and written with numpy alone.

An Orbax checkpoint keeps its arrays in an OCDBT ("optionally-cooperative
distributed B+tree") database at the checkpoint's root. The format is
not documented here; what follows was found in files that tensorstore
writes (field names are ours). Integers are unsigned LEB128 varints unless
a width is given; ``x[n]`` is n values of x one after another.

File header, shared by the manifest and every B+tree and version-tree
node: ``magic`` u32 big-endian (manifest ``0x0cdb3a2a``, B+tree node
``0x0cdb20de``, version-tree node ``0x0cdb1234``), ``length`` u64 LE (the
whole record, header and checksum included), ``version`` (0),
``compression`` (0 none, 1 zstd: the body is one zstd frame), then the body
and a CRC-32C (Castagnoli) u32 LE of every byte before it.

Data file table (in the manifest and in each node): ``count``,
``prefix[count-1]`` (bytes shared with the previous path), ``suffix[count]``,
``base[count]`` (length of the path's base part), then the suffix bytes.
Paths are relative to the database root; a node read through a path whose
base is ``B`` (``ocdbt.process_0/`` where the root database points into a
process's database) resolves its own paths below ``B``.

Manifest body (kind 0, "single": the versions are inline):
``uuid`` 16 bytes, ``kind``, ``max_inline_value_bytes``,
``max_decoded_node_bytes``, ``version_tree_arity_log2`` u8,
``compression`` (0 none, 1 zstd then its level as i32 LE), the data file
table, ``n`` versions: ``generation[n]``, ``root_height[n]`` u8,
``data_file[n]``, ``offset[n]``, ``length[n]`` (an empty tree has length
0), ``num_keys[n]``, ``num_tree_bytes[n]``,
``num_indirect_value_bytes[n]``, ``commit_time[n]`` u64 LE (ns since the
epoch); then references to version-tree nodes that hold older versions
(not needed: the newest version is always inline).

B+tree node body: ``height`` u8, the data file table, ``n`` entries,
``key_prefix[n-1]`` (bytes shared with the previous key),
``key_suffix[n]``, then for an interior node (height > 0)
``subtree_common_prefix[n]``, the key bytes, ``data_file[n]``,
``offset[n]``, ``length[n]``, ``num_keys[n]``, ``num_tree_bytes[n]``,
``num_indirect_value_bytes[n]``: each entry is a child whose keys start at
its key and are stored without its first ``subtree_common_prefix`` bytes.
For a leaf (height 0) the key bytes, ``value_length[n]``,
``value_kind[n]`` (0 inline, 1 indirect), ``data_file[m]`` and
``offset[m]`` of the m indirect values, then the inline values back to
back. An indirect value is ``length`` bytes at ``offset`` of a data file
under ``d/``, where values and nodes sit back to back.

The writer writes one version of a new database: its manifest, a leaf
node (and interior nodes only where ``MAX_DECODED_NODE_BYTES`` forces
them) and one data file holding the indirect values and the nodes.
"""

from __future__ import annotations

import os
import secrets
import struct
import time

import numpy as np

from fast_cwdm_tpu_torch.training import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024  # what Orbax configures
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _crc_table() -> np.ndarray:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(0x82F63B78), c >> 1).astype(np.uint32)
    return c


_CRC = _crc_table().tolist()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    t = _CRC
    for b in bytes(data):
        c = t[(c ^ b) & 255] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, data: bytes, where: str):
        self.data, self.p, self.where = data, 0, where

    def fail(self, msg: str):
        raise ValueError(f"{self.where}: {msg}")

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.p >= len(self.data) or shift > 63:
                self.fail("truncated or corrupt varint")
            b = self.data[self.p]
            self.p += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.p:self.p + n]
        self.p += n
        return out

    def u8s(self, n: int) -> list[int]:
        return list(self.take(n))

    def file_table(self) -> list[tuple[str, str]]:
        """``[(path, base)]``."""
        n = self.varint()
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        base = self.varints(n)
        paths: list[str] = []
        for i in range(n):
            prev = paths[-1] if paths else ""
            if prefix[i] > len(prev):
                self.fail("bad data file table")
            paths.append(prev[:prefix[i]] + self.take(suffix[i]).decode())
            if base[i] > len(paths[-1]):
                self.fail("bad data file table")
        return [(p, p[:b]) for p, b in zip(paths, base)]

    def keys(self, n: int) -> tuple[list[int], list[int]]:
        prefix = [0] + self.varints(n - 1) if n else []
        return prefix, self.varints(n)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _open_record(raw: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or node record, its checksum checked."""
    if len(raw) < 18:
        raise ValueError(f"{where}: truncated record")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{where}: bad magic {got_magic:#010x}")
    if length != len(raw):
        raise ValueError(f"{where}: record says {length} bytes, has {len(raw)}")
    if crc32c(raw[:-4]) != struct.unpack_from("<I", raw, len(raw) - 4)[0]:
        raise ValueError(f"{where}: CRC-32C mismatch")
    cur = _Cursor(raw[:-4], where)
    cur.p = 12
    if cur.varint() != 0:
        cur.fail("unknown format version")
    compression = cur.varint()
    body = raw[cur.p:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    cur.fail(f"unknown compression {compression}")


def _record(magic: int, body: bytes) -> bytes:
    """A record with a zstd body, as tensorstore writes them."""
    payload = b"\x00\x01" + zstd.compress(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    rec = head + payload
    return rec + struct.pack("<I", crc32c(rec))


def _file_table(paths: list[str]) -> bytes:
    enc = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(enc, enc[1:])]
    suffix = [e[k:] for e, k in zip(enc, [0] + prefix)]
    return (_varint(len(enc)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + _varints(0 for _ in enc) + b"".join(suffix))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class Reader:
    """The newest version of the database at ``root``: :meth:`list` and
    :meth:`read`. Every checksum is checked; a truncated or corrupt record,
    or a missing data file, raises ``ValueError`` naming its path."""

    def __init__(self, root: str):
        self.root = root
        self._files: dict[str, bytes] = {}
        self._values: dict[bytes, tuple] = {}  # key -> ("inline", bytes) | (path, off, len)
        where = os.path.join(root, "manifest.ocdbt")
        try:
            with open(where, "rb") as f:
                raw = f.read()
        except FileNotFoundError as e:
            raise ValueError(f"{where}: no OCDBT manifest") from e
        cur = _Cursor(_open_record(raw, MANIFEST_MAGIC, where), where)
        cur.take(16)
        if cur.varint() != 0:
            cur.fail("only single-file manifests are supported")
        self.max_inline_value_bytes = cur.varint()
        self.max_decoded_node_bytes = cur.varint()
        cur.take(1)
        if cur.varint() == 1:
            cur.take(4)
        files = cur.file_table()
        n = cur.varint()
        if n == 0:
            return
        gen = cur.varints(n)
        height = cur.u8s(n)
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)
        cur.take(8 * n)
        v = max(range(n), key=gen.__getitem__)
        if length[v] == 0:
            return
        if fid[v] >= len(files):
            cur.fail("bad data file id")
        path, base = files[fid[v]]
        self._walk(path, base, off[v], length[v], height[v], b"")

    def _file(self, path: str) -> bytes:
        if path not in self._files:
            full = os.path.join(self.root, path)
            try:
                with open(full, "rb") as f:
                    self._files[path] = f.read()
            except FileNotFoundError as e:
                raise ValueError(f"{full}: missing OCDBT data file") from e
        return self._files[path]

    def _slice(self, path: str, off: int, length: int) -> memoryview:
        data = self._file(path)
        if off + length > len(data):
            raise ValueError(f"{os.path.join(self.root, path)}: truncated "
                             f"({off}+{length} of {len(data)} bytes)")
        return memoryview(data)[off:off + length]

    def _walk(self, path: str, base: str, off: int, length: int, height: int,
              prefix: bytes) -> None:
        where = f"{os.path.join(self.root, path)}@{off}"
        cur = _Cursor(_open_record(bytes(self._slice(path, off, length)), NODE_MAGIC, where),
                      where)
        if cur.u8s(1)[0] != height:
            cur.fail("node height disagrees with its parent")
        files = [(base + p, base + b) for p, b in cur.file_table()]
        n = cur.varint()
        kprefix, ksuffix = cur.keys(n)
        if height:
            common = cur.varints(n)
        keys: list[bytes] = []
        for i in range(n):
            prev = keys[-1] if keys else b""
            if kprefix[i] > len(prev):
                cur.fail("bad key prefix")
            keys.append(prev[:kprefix[i]] + cur.take(ksuffix[i]))
        if height:
            fid, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)
            for i in range(n):
                if fid[i] >= len(files) or common[i] > len(keys[i]):
                    cur.fail("bad child reference")
                p, b = files[fid[i]]
                self._walk(p, b, offs[i], lens[i], height - 1, prefix + keys[i][:common[i]])
            return
        vlen = cur.varints(n)
        kind = cur.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k > 1 for k in kind):
            cur.fail("unknown value kind")
        fid, offs = cur.varints(len(indirect)), cur.varints(len(indirect))
        for j, i in enumerate(indirect):
            if fid[j] >= len(files):
                cur.fail("bad data file id")
            self._values[prefix + keys[i]] = (files[fid[j]][0], offs[j], vlen[i])
        for i in range(n):
            if kind[i] == 0:
                self._values[prefix + keys[i]] = ("", cur.take(vlen[i]), None)
        if cur.p != len(cur.data):
            cur.fail("bytes after the last value")

    def list(self) -> list[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._values)

    def read(self, key: str) -> bytes | memoryview:
        """The value of ``key`` (a view into its data file for an indirect
        value); ``KeyError`` if there is none."""
        path, a, n = self._values[key.encode()]
        return a if n is None else self._slice(path, a, n)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _leaf(items: list[tuple[bytes, bytes]], inline_limit: int, offsets: dict) -> bytes:
    keys = [k for k, _ in items]
    kp = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    kind = [int(len(v) > inline_limit) for _, v in items]
    indirect = [offsets[k] for k, kd in zip(keys, kind) if kd]
    return b"".join([
        b"\x00", _file_table(["d/" + offsets["file"]] if indirect else []), _varint(len(items)),
        _varints(kp), _varints(len(k) - p for k, p in zip(keys, [0] + kp)),
        b"".join(k[p:] for k, p in zip(keys, [0] + kp)),
        _varints(len(v) for _, v in items), _varints(kind),
        _varints(0 for _ in indirect), _varints(indirect),
        b"".join(v for (_, v), kd in zip(items, kind) if not kd)])


def _interior(height: int, children: list[tuple], file: str) -> bytes:
    """children: ``(first key, offset, length, num_keys, tree_bytes,
    indirect_bytes)``; child keys are stored whole (no common prefix)."""
    keys = [c[0] for c in children]
    kp = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    n = len(children)
    return b"".join([
        bytes([height]), _file_table(["d/" + file]), _varint(n), _varints(kp),
        _varints(len(k) - p for k, p in zip(keys, [0] + kp)), _varints(0 for _ in keys),
        b"".join(k[p:] for k, p in zip(keys, [0] + kp)),
        _varints(0 for _ in keys), *(_varints(c[j] for c in children) for j in range(1, 6))])


def write(root: str, items: dict[str, bytes]) -> None:
    """A new database at ``root`` (a directory that holds none) with one
    version holding ``items``: values above ``MAX_INLINE_VALUE_BYTES`` go
    to one data file ``d/<32 hex>``, followed by the B+tree nodes (split
    under ``MAX_DECODED_NODE_BYTES``); then the manifest. Both limits are
    read at call time and recorded in the manifest's config."""
    max_inline_value_bytes = MAX_INLINE_VALUE_BYTES
    max_decoded_node_bytes = MAX_DECODED_NODE_BYTES
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    name = secrets.token_hex(16)
    pairs = sorted((k.encode(), bytes(v)) for k, v in items.items())
    offsets: dict = {"file": name}
    pos = 0
    with open(os.path.join(root, "d", name), "wb") as f:
        for k, v in pairs:
            if len(v) > max_inline_value_bytes:
                f.write(v)
                offsets[k] = pos
                pos += len(v)
        indirect_bytes = pos
        # leaves: as many items as fit under the node limit
        groups, cur, size = [], [], 0
        for k, v in pairs:
            add = len(k) + 12 + (len(v) if len(v) <= max_inline_value_bytes else 0)
            if cur and size + add > max_decoded_node_bytes // 2:
                groups.append(cur)
                cur, size = [], 0
            cur.append((k, v))
            size += add
        groups.append(cur)
        level = []
        height = 0
        for g in groups:
            rec = _record(NODE_MAGIC, _leaf(g, max_inline_value_bytes, offsets))
            f.write(rec)
            ind = sum(len(v) for _, v in g if len(v) > max_inline_value_bytes)
            level.append((g[0][0] if g and level else b"", pos, len(rec), len(g), len(rec), ind))
            pos += len(rec)
        while len(level) > 1:
            height += 1
            per = max(2, max_decoded_node_bytes // 2 // 64)
            nxt = []
            for i in range(0, len(level), per):
                kids = level[i:i + per]
                rec = _record(NODE_MAGIC, _interior(height, kids, name))
                f.write(rec)
                nxt.append((kids[0][0], pos, len(rec), sum(c[3] for c in kids),
                            len(rec) + sum(c[4] for c in kids), sum(c[5] for c in kids)))
                pos += len(rec)
            level = nxt
        f.flush()
        os.fsync(f.fileno())
    _, root_off, root_len, num_keys, tree_bytes, _ = level[0]
    body = b"".join([
        secrets.token_bytes(16), b"\x00", _varint(max_inline_value_bytes),
        _varint(max_decoded_node_bytes), bytes([VERSION_TREE_ARITY_LOG2]), b"\x01",
        struct.pack("<i", 0), _file_table(["d/" + name]), b"\x01", b"\x01", bytes([height]),
        b"\x00", _varint(root_off), _varint(root_len), _varint(num_keys), _varint(tree_bytes),
        _varint(indirect_bytes), struct.pack("<Q", time.time_ns()), b"\x00"])
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_record(MANIFEST_MAGIC, body))
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(os.path.join(root, "d"))
    fsync_dir(root)


def fsync_dir(path: str) -> None:
    """Make the entries of directory ``path`` durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
