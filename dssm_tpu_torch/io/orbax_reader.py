"""Read dssm_tpu's orbax checkpoints with numpy and ctypes alone.

dssm_tpu saves its TrainState with orbax's StandardSave
(dssm_tpu/io/checkpoint.py), one directory a step:

    workdir/checkpoints/<step>/default/
        _METADATA                   JSON: the tree path of every leaf
        manifest.ocdbt              the OCDBT manifest of the whole step
        d/<id>                      its B-tree nodes
        ocdbt.process_<i>/          each process's B-tree and data files

The arrays are zarr v2 arrays in a tensorstore OCDBT key-value store: each
leaf `a.b.c` has the keys `a.b.c/.zarray` (JSON: shape, chunks, dtype,
compressor, order, fill value) and one key a chunk (`0.0`, `1.0`, ...).
The manifest names the B-tree's root; the top manifest's tree holds the
keys of every process, and its data file table names the files under
each `ocdbt.process_<i>/`. Every manifest and node is framed alike: a
4-byte magic (big-endian), its whole length (u64le), a format version and
a compression byte (varints), the body (a zstd frame when the compression
byte is 1), and the CRC-32C of all that (u32le). Chunks are zstd frames.
zstd is decoded by the system's libzstd.so.1 through ctypes.

read_checkpoint returns the state in dssm_tpu's tree: {"step", "params",
"opt_state"} with numpy leaves, dicts for dict and namedtuple nodes and
lists for tuples (optax's chains), None for an empty optax state. A
bfloat16 leaf comes back as a BFloat16Array: its bits as uint16, since
numpy has no bfloat16 of its own (bridge._to_tensor views it as
torch.bfloat16). A chunked array, e.g. a table orbax wrote in per-shard
chunks, is assembled whole. Anything the reader cannot decode raises
OrbaxFormatError naming the file; nothing is skipped.
"""

from __future__ import annotations

import ast
import ctypes
import ctypes.util
import itertools
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

CHECKPOINT_DIR = "checkpoints"
ITEM_DIR = "default"
MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_MAGIC = 0x0CDB20DE
# A header: magic u32be, length u64le; then version and compression
# varints (one byte each in every format version so far); a CRC-32C u32le
# ends the blob.
_HEADER = 12
_CRC = 4
# Decoded manifests are small; nodes are bounded by the manifest's
# max_decoded_node_bytes.
_MAX_MANIFEST_BYTES = 64 << 20


class OrbaxFormatError(ValueError):
    """A dssm_tpu checkpoint this reader cannot decode; names the file."""

    def __init__(self, path: str, what: str):
        super().__init__(f"{path}: {what}")
        self.path = path


class BFloat16Array(np.ndarray):
    """The bits of a bfloat16 array, as uint16."""


# ---------------------------------------------------------------- zstd

_zstd: Optional[ctypes.CDLL] = None
_ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2


def _libzstd() -> ctypes.CDLL:
    global _zstd
    if _zstd is None:
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise RuntimeError(
                "no libzstd found (ctypes.util.find_library('zstd')): the "
                "system's zstd library is needed to read dssm_tpu's orbax "
                "checkpoints")
        lib = ctypes.CDLL(name)
        size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ptr, size_t]
        lib.ZSTD_decompress.restype = size_t
        lib.ZSTD_decompress.argtypes = [ptr, size_t, ptr, size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [size_t]
        lib.ZSTD_versionString.restype = ctypes.c_char_p
        lib.ZSTD_versionString.argtypes = []
        lib._dssm_name = name
        _zstd = lib
    return _zstd


def zstd_library() -> str:
    """The zstd decoder this reader loads: its name and version."""
    lib = _libzstd()
    return f"{lib._dssm_name} {lib.ZSTD_versionString().decode()}"


def _unzstd_into(data: bytes, out: np.ndarray, path: str) -> int:
    """Decode one zstd frame into `out` (a contiguous uint8 buffer); the
    decoded size."""
    lib = _libzstd()
    n = lib.ZSTD_decompress(out.ctypes.data, out.nbytes, data, len(data))
    if lib.ZSTD_isError(n):
        raise OrbaxFormatError(
            path, "zstd: " + lib.ZSTD_getErrorName(n).decode())
    return n


def _unzstd(data: bytes, path: str, limit: int) -> bytes:
    """Decode a zstd frame of unknown size, at most `limit` bytes."""
    lib = _libzstd()
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise OrbaxFormatError(path, "not a zstd frame")
    if size != _ZSTD_CONTENTSIZE_UNKNOWN:
        if size > limit:
            raise OrbaxFormatError(path, f"{size} decoded bytes, over "
                                   f"the limit of {limit}")
        out = np.empty(size, np.uint8)
        if _unzstd_into(data, out, path) != size:
            raise OrbaxFormatError(path, "zstd: short frame")
        return out.tobytes()
    # The frame does not say its size: grow the buffer until it fits.
    cap = min(limit, max(1 << 20, 16 * len(data)))
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.ZSTD_decompress(out.ctypes.data, cap, data, len(data))
        if not lib.ZSTD_isError(n):
            return out[:n].tobytes()
        if cap >= limit:
            raise OrbaxFormatError(
                path, "zstd: " + lib.ZSTD_getErrorName(n).decode()
                + f" (at {cap} bytes)")
        cap = min(limit, 2 * cap)


# ---------------------------------------------------------------- OCDBT

def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of a decoded body; running past its end raises."""

    def __init__(self, data: bytes, path: str):
        self.data, self.pos, self.path = data, 0, path

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError(self.path, "truncated body")

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(self.path, "varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _unframe(blob: bytes, magic: int, path: str, limit: int) -> bytes:
    """The body of a manifest or node blob, its frame checked."""
    if len(blob) < _HEADER + 2 + _CRC:
        raise OrbaxFormatError(path, f"{len(blob)} bytes, too short")
    (got_magic,) = struct.unpack_from(">I", blob)
    (length,) = struct.unpack_from("<Q", blob, 4)
    if got_magic != magic:
        raise OrbaxFormatError(path, f"magic {got_magic:#010x}, expected "
                               f"{magic:#010x}")
    if length != len(blob):
        raise OrbaxFormatError(path, f"{len(blob)} bytes, its header says "
                               f"{length}")
    want_crc = struct.unpack_from("<I", blob, len(blob) - _CRC)[0]
    if _crc32c(blob[:-_CRC]) != want_crc:
        raise OrbaxFormatError(path, "CRC-32C mismatch")
    head = _Cursor(blob[_HEADER:-_CRC], path)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(path, f"format version {version}")
    body = blob[_HEADER + head.pos:-_CRC]
    if compression == 0:
        return body
    if compression == 1:
        return _unzstd(body, path, limit)
    raise OrbaxFormatError(path, f"compression format {compression}")


def _file_table(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """A data file table: (path under the store's root, the base path that
    the file's own tables are relative to) for each file."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OrbaxFormatError(cur.path, "bad data file table")
        name = prev[:prefix[i]] + cur.raw(suffix[i])
        prev = name
        text = name.decode()
        files.append((base + text, base + text[:base_len[i]]))
    return files


class _Store:
    """One OCDBT store (a step's `default/` directory): the location of
    every key's value, read when asked for."""

    def __init__(self, root: str):
        self.root = root
        # key -> (file under root, offset, length, the value if inline)
        self.values: Dict[bytes, Tuple[str, int, int, Optional[bytes]]] = {}
        self._max_node = _MAX_MANIFEST_BYTES
        self._read_manifest()

    def _range(self, rel: str, offset: int, length: Optional[int] = None
               ) -> bytes:
        path = os.path.join(self.root, rel)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length is None else f.read(length)
        except OSError as e:
            raise OrbaxFormatError(path, f"cannot read: {e}") from e
        if length is not None and len(data) != length:
            raise OrbaxFormatError(path, f"ends before byte {offset + length}"
                                   " that a reference needs")
        return data

    def _read_manifest(self) -> None:
        path = os.path.join(self.root, MANIFEST)
        body = _unframe(self._range(MANIFEST, 0), _MANIFEST_MAGIC, path,
                        _MAX_MANIFEST_BYTES)
        cur = _Cursor(body, path)
        cur.raw(16)  # the store's uuid
        if cur.varint() != 0:
            raise OrbaxFormatError(path, "a numbered manifest (only the "
                                   "single-file manifest orbax writes is "
                                   "read)")
        cur.varint()  # max_inline_value_bytes
        self._max_node = cur.varint()
        cur.u8()  # version_tree_arity_log2
        method = cur.varint()  # the nodes' compression: 0 none, 1 zstd
        if method == 1:
            cur.raw(4)  # the zstd level, int32le
        elif method != 0:
            raise OrbaxFormatError(path, f"compression method {method}")
        files = _file_table(cur, "")
        # The newest versions are inline (older ones live in version tree
        # nodes, which are not needed): generation, root height, root
        # node location, statistics and commit time, a column each.
        n = cur.varint()
        if n == 0:
            raise OrbaxFormatError(path, "an empty store")
        gens = cur.varints(n)
        heights = [cur.u8() for _ in range(n)]
        fids, offsets, lengths = (cur.varints(n), cur.varints(n),
                                  cur.varints(n))
        newest = max(range(n), key=gens.__getitem__)
        if fids[newest] >= len(files):
            raise OrbaxFormatError(path, "the root names no data file")
        rel, base = files[fids[newest]]
        self._walk(rel, offsets[newest], lengths[newest], base, b"",
                   heights[newest])

    def _walk(self, rel: str, offset: int, length: int, base: str,
              key_prefix: bytes, height: int) -> None:
        path = os.path.join(self.root, rel)
        body = _unframe(self._range(rel, offset, length), _BTREE_MAGIC,
                        path, self._max_node)
        cur = _Cursor(body, path)
        got_height = cur.u8()
        if got_height != height:
            raise OrbaxFormatError(path, f"a node of height {got_height}, "
                                   f"its reference says {height}")
        files = _file_table(cur, base)
        n = cur.varint()
        if n == 0:
            raise OrbaxFormatError(path, "an empty node")
        # Keys: each one's prefix length shared with the key before, then
        # the suffix lengths, (interior nodes) the prefix length the whole
        # subtree shares, then the suffix bytes.
        shared = [0] + cur.varints(n - 1)
        suffix = cur.varints(n)
        common = cur.varints(n) if height > 0 else None
        keys, prev = [], b""
        for p, s in zip(shared, suffix):
            if p > len(prev):
                raise OrbaxFormatError(path, "bad key prefix")
            prev = prev[:p] + cur.raw(s)
            keys.append(prev)
        if height > 0:
            fids, offsets, lengths = (cur.varints(n), cur.varints(n),
                                      cur.varints(n))
            for i in range(n):
                if fids[i] >= len(files) or common[i] > len(keys[i]):
                    raise OrbaxFormatError(path, "bad child reference")
                child, child_base = files[fids[i]]
                # A child's keys are stored without its subtree's prefix.
                self._walk(child, offsets[i], lengths[i], child_base,
                           key_prefix + keys[i][:common[i]], height - 1)
            return
        sizes = cur.varints(n)
        kinds = [cur.u8() for _ in range(n)]  # 0 inline, 1 in a data file
        if any(k > 1 for k in kinds):
            raise OrbaxFormatError(path, "unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        fids, offsets = (cur.varints(len(indirect)),
                         cur.varints(len(indirect)))
        for j, i in enumerate(indirect):
            if fids[j] >= len(files):
                raise OrbaxFormatError(path, "a value names no data file")
            self.values[key_prefix + keys[i]] = (files[fids[j]][0],
                                                 offsets[j], sizes[i], None)
        for i in range(n):
            if kinds[i] == 0:
                self.values[key_prefix + keys[i]] = (rel, offset, sizes[i],
                                                     cur.raw(sizes[i]))

    def get(self, key: str) -> Optional[bytes]:
        ref = self.values.get(key.encode())
        if ref is None:
            return None
        rel, offset, length, inline = ref
        return inline if inline is not None else self._range(rel, offset,
                                                             length)

    def where(self, key: str) -> str:
        """The file that holds a key's value, for messages."""
        ref = self.values.get(key.encode())
        return os.path.join(self.root, ref[0] if ref else MANIFEST)


# ---------------------------------------------------------------- zarr

def _zarr_dtype(spec: str, path: str) -> Tuple[np.dtype, bool]:
    """(storage dtype, whether the array is bfloat16)."""
    if spec == "bfloat16":
        return np.dtype(np.uint16), True
    try:
        dtype = np.dtype(spec)
    except TypeError as e:
        raise OrbaxFormatError(path, f"dtype {spec!r}") from e
    if dtype.kind not in "biuf":
        raise OrbaxFormatError(path, f"dtype {spec!r}")
    return dtype, False


def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if bf16:
        return int(np.array(float(value), np.float32).view(np.uint32) >> 16)
    return np.array(value, dtype=dtype)


def _read_array(store: _Store, name: str) -> np.ndarray:
    meta_key = f"{name}/.zarray"
    raw = store.get(meta_key)
    where = os.path.join(store.root, name)
    if raw is None:
        raise OrbaxFormatError(where, f"no key {meta_key!r} in the store")
    try:
        meta = json.loads(raw)
        shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
        dtype_spec, order = meta["dtype"], meta["order"]
    except (ValueError, KeyError, TypeError) as e:
        raise OrbaxFormatError(where, f"bad .zarray: {e}") from e
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise OrbaxFormatError(where, "not a plain zarr v2 array")
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor not in (None, "zstd"):
        raise OrbaxFormatError(where, f"compressor {compressor!r}")
    if order not in ("C", "F") or len(chunks) != len(shape):
        raise OrbaxFormatError(where, f"order {order!r}, chunks {chunks}")
    dtype, bf16 = _zarr_dtype(dtype_spec, where)
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16),
                  dtype=dtype.newbyteorder("="))
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [range(-(-s // c)) if c else range(0)
            for s, c in zip(shape, chunks)]
    for pos in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, pos)) if pos else '0'}"
        data = store.get(key)
        if data is None:
            continue  # never written: the fill value
        buf = np.empty(chunk_bytes, np.uint8)
        if compressor == "zstd":
            n = _unzstd_into(data, buf, store.where(key))
        else:
            n = len(data)
            buf[:min(n, chunk_bytes)] = np.frombuffer(data, np.uint8)[
                :chunk_bytes]
        if n != chunk_bytes:
            raise OrbaxFormatError(store.where(key),
                                   f"chunk {key!r}: {n} bytes, expected "
                                   f"{chunk_bytes}")
        chunk = buf.view(dtype).reshape(chunks, order=order)
        box = tuple(slice(p * c, min((p + 1) * c, s))
                    for p, c, s in zip(pos, chunks, shape))
        out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
    return out.view(BFloat16Array) if bf16 else out


# ---------------------------------------------------------------- steps

def _step_dirs(workdir: str) -> Tuple[str, List[str]]:
    """workdir/checkpoints and the names in it that are a step number."""
    path = os.path.join(os.path.abspath(workdir), CHECKPOINT_DIR)
    if not os.path.isdir(path):
        return path, []
    return path, [n for n in os.listdir(path) if n.isdigit()]


def has_checkpoint(workdir: str) -> bool:
    """Whether workdir/checkpoints holds a step directory, whole or not."""
    return bool(_step_dirs(workdir)[1])


def checkpoint_steps(workdir: str) -> List[int]:
    """Steps of the whole dssm_tpu (orbax) checkpoints under
    workdir/checkpoints: directories named by a step number that hold
    their item's metadata. A `<step>.stale` directory (dssm_tpu's saver
    moves a superseded step there), orbax's temporary directories and a
    step directory without its metadata are not steps."""
    path, names = _step_dirs(workdir)
    return sorted(int(n) for n in names if os.path.isfile(
        os.path.join(path, n, ITEM_DIR, "_METADATA")))


def _tree_paths(meta_path: str) -> List[Tuple[List[Tuple[str, int]], dict]]:
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        tree = meta["tree_metadata"]
    except (OSError, ValueError, KeyError) as e:
        raise OrbaxFormatError(meta_path, f"cannot read: {e}") from e
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(meta_path, "zarr v3 arrays (only the zarr "
                               "v2 arrays orbax writes by default are read)")
    out = []
    for text, entry in tree.items():
        keys = entry.get("key_metadata")
        if keys is None:  # older metadata: the path only, all dict keys
            keys = [{"key": k, "key_type": 2}
                    for k in ast.literal_eval(text)]
        out.append(([(k["key"], k["key_type"]) for k in keys],
                    entry.get("value_metadata", {})))
    return out


def _insert(tree: dict, keys: List[Tuple[str, int]], value) -> None:
    """Put a leaf at its path: dict keys (key_type 2) make dicts, sequence
    keys (key_type 1) make {int: ...} maps, turned into lists after."""
    node = tree
    for i, (key, kind) in enumerate(keys):
        key = int(key) if kind == 1 else key
        if i == len(keys) - 1:
            node[key] = value
        else:
            node = node.setdefault(key, {})


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in sorted(node)]
    return {k: _lists(v) for k, v in node.items()}


def read_checkpoint(workdir: str, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, Any]]:
    """(step, state) of dssm_tpu's checkpoint of `step` under
    workdir/checkpoints (default: the newest whole one). The state is
    dssm_tpu's TrainState tree as numpy (see the module's docstring)."""
    steps = checkpoint_steps(workdir)
    if step is None:
        path, names = _step_dirs(workdir)
        if not steps:
            if names:
                raise OrbaxFormatError(
                    os.path.join(path, max(names, key=int), ITEM_DIR,
                                 "_METADATA"),
                    "missing: no whole checkpoint under " + path)
            raise FileNotFoundError(f"no dssm_tpu checkpoint under {path}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(
            f"no dssm_tpu checkpoint of step {step} under "
            f"{workdir}/{CHECKPOINT_DIR} (steps: {steps})")
    root = os.path.join(os.path.abspath(workdir), CHECKPOINT_DIR, str(step),
                        ITEM_DIR)
    leaves = _tree_paths(os.path.join(root, "_METADATA"))
    store = _Store(root)
    tree: dict = {}
    for keys, value_meta in leaves:
        kind = value_meta.get("value_type")
        if kind == "None" or value_meta.get("skip_deserialize"):
            value = None
        elif kind in ("jax.Array", "np.ndarray", "scalar"):
            value = _read_array(store, ".".join(k for k, _ in keys))
        else:
            raise OrbaxFormatError(os.path.join(root, "_METADATA"),
                                   f"leaf {keys} of type {kind!r}")
        _insert(tree, keys, value)
    return step, _lists(tree)
