"""Keras .h5 weights into the port's Mask R-CNN, without h5py.

The counterpart of slam_maskrcnn_tpu/models/import_h5.py
(``load_h5_weights``). Where the port runs there is no h5py, so ``H5File``
reads the part of HDF5 that h5py writes by default, with numpy:

* superblock version 0 or 1;
* version-1 object headers, with continuation blocks;
* old-style groups: a symbol-table message pointing at a version-1 B-tree
  of group nodes, whose leaves are SNOD symbol nodes, names in a local
  heap; walked at any depth;
* dataspace messages version 1 and 2;
* datatypes of class 0 (integers) and 1 (IEEE floats: f16, f32, f64),
  little-endian;
* data layout message version 3, contiguous or compact.

Every array is read at its address through ``np.memmap``. What lies
outside this subset (superblock 2 or 3, version-2 object headers,
new-style groups with link messages, chunked layouts, filter pipelines
such as gzip, big-endian types, other datatype classes) raises ``H5Error``
naming it: the reader never returns data it did not understand.

``load_h5_weights`` follows the JAX importer: a layer is the innermost
group that owns datasets (so the nested ``rpn_model`` group of real
checkpoints maps too), ``exclude`` takes regexes of layer names, a
Conv2DTranspose kernel [kh, kw, cout, cin] is transposed to Flax's [kh,
kw, cin, cout], and the Flax-layout arrays are written into the port's
tensors by models/weights.py (f16 widened to the tensor's dtype). With
``strict`` it fails unless every port tensor was written and every file
layer consumed, as the JAX importer does.

``save_h5_weights`` is the counterpart of the JAX package's writer
(import_h5.py:79-100), again without h5py: ``H5Writer`` writes the same
subset the reader parses (superblock 0, version-1 object headers,
symbol-table groups, contiguous little-endian datasets) in the Keras
layout ``model_weights/<layer>/<layer>/<name>:0``, the deconv kernel as
Keras's [kh, kw, cout, cin]. h5py, the JAX package's strict loader and
this module's read what it writes.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from slam_maskrcnn_tpu_torch.device import resolve_device

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF


class H5Error(ValueError):
    """An HDF5 construct this reader does not implement, or a damaged
    file."""


class H5File:
    """Read-only view of an HDF5 file in the subset h5py writes by default.
    ``datasets()`` walks every dataset: (path, array) in the name order of
    h5py's ``visititems``."""

    def __init__(self, path: str):
        self.path = str(path)
        self.buf = np.memmap(self.path, np.uint8, mode="r")
        b = self._bytes(0, 8)
        if b != SIGNATURE:
            raise H5Error(f"{path}: not an HDF5 file (bad signature)")
        version = self.buf[8]
        if version not in (0, 1):
            raise H5Error(f"{path}: superblock version {version} is not "
                          "supported (0 or 1)")
        self.so, self.sl = int(self.buf[13]), int(self.buf[14])
        if (self.so, self.sl) != (8, 8):
            raise H5Error(f"{path}: offset/length sizes {self.so}/{self.sl} "
                          "are not supported (8/8)")
        pos = 24 + (4 if version == 1 else 0)
        self.base = self._uint(pos, 8)
        root = pos + 4 * 8                       # base, free, eof, driver
        self.root = self._uint(root + 8, 8)      # symbol table entry: header

    # -- raw access ---------------------------------------------------------

    def _bytes(self, pos: int, n: int) -> bytes:
        return bytes(self.buf[pos:pos + n])

    def _uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self._bytes(pos, n), "little")

    def _addr(self, a: int) -> int:
        return a if a == UNDEFINED else a + self.base

    # -- object headers -----------------------------------------------------

    def messages(self, addr: int):
        """(type, body offset, size) of every message of the object header
        at ``addr`` (file address), continuation blocks included."""
        pos = self._addr(addr)
        if self._bytes(pos, 4) == b"OHDR":
            raise H5Error("version-2 object headers are not supported")
        if self.buf[pos] != 1:
            raise H5Error(f"object header version {self.buf[pos]} at "
                          f"{addr:#x} is not supported")
        n_msgs = self._uint(pos + 2, 2)
        blocks = [(pos + 16, self._uint(pos + 8, 4))]
        out = []
        while blocks and len(out) < n_msgs:
            start, size = blocks.pop(0)
            p = start
            while p + 8 <= start + size and len(out) < n_msgs:
                mtype, msize = self._uint(p, 2), self._uint(p + 2, 2)
                body = p + 8
                if self.buf[p + 4] & 0x02:
                    raise H5Error("shared object header messages are not "
                                  "supported")
                if mtype == 0x10:                       # continuation
                    blocks.append((self._addr(self._uint(body, 8)),
                                   self._uint(body + 8, 8)))
                out.append((mtype, body, msize))
                p = body + msize
        return out

    # -- groups ---------------------------------------------------------------

    def _children(self, addr: int) -> list[tuple[str, int]] | None:
        """(name, object header address) of a group's members, or None for
        a dataset."""
        table = None
        for mtype, body, _ in self.messages(addr):
            if mtype == 0x11:                           # symbol table
                table = (self._uint(body, 8), self._uint(body + 8, 8))
            elif mtype in (0x02, 0x06, 0x0A):
                raise H5Error("new-style groups (link info / link messages) "
                              "are not supported")
            elif mtype == 0x08:
                return None
        if table is None:
            raise H5Error(f"object at {addr:#x} is neither a symbol-table "
                          "group nor a dataset")
        btree, heap = (self._addr(a) for a in table)
        if self._bytes(heap, 4) != b"HEAP":
            raise H5Error(f"bad local heap signature at {heap:#x}")
        heap_data = self._addr(self._uint(heap + 24, 8))
        out = []
        self._walk_btree(btree, heap_data, out)
        return out

    def _walk_btree(self, node: int, heap_data: int, out: list) -> None:
        if self._bytes(node, 4) != b"TREE":
            raise H5Error(f"bad B-tree node signature at {node:#x}")
        if self.buf[node + 4] != 0:
            raise H5Error("a chunked-data B-tree where a group's was expected")
        level, used = int(self.buf[node + 5]), self._uint(node + 6, 2)
        # keys and children interleave after the two sibling addresses:
        # key_0 child_0 key_1 child_1 ... key_used
        for i in range(used):
            child = self._addr(self._uint(node + 24 + 8 + 16 * i, 8))
            if level > 0:
                self._walk_btree(child, heap_data, out)
            else:
                self._read_snod(child, heap_data, out)

    def _read_snod(self, pos: int, heap_data: int, out: list) -> None:
        if self._bytes(pos, 4) != b"SNOD":
            raise H5Error(f"bad symbol node signature at {pos:#x}")
        n = self._uint(pos + 6, 2)
        for i in range(n):
            e = pos + 8 + 40 * i
            name_off = self._uint(e, 8)
            s = heap_data + name_off
            end = s
            while self.buf[end] != 0:
                end += 1
            out.append((self._bytes(s, end - s).decode("utf-8"),
                        self._uint(e + 8, 8)))

    # -- datasets -------------------------------------------------------------

    def _dtype(self, body: int) -> np.dtype:
        cls, version = self.buf[body] & 0x0F, self.buf[body] >> 4
        bits = self._uint(body + 1, 3)
        size = self._uint(body + 4, 4)
        if cls == 1:
            if bits & 0x41:
                raise H5Error("big-endian (or VAX) floating point is not "
                              "supported")
            if size not in (2, 4, 8):
                raise H5Error(f"{8 * size}-bit floats are not supported")
            return np.dtype(f"<f{size}")
        if cls == 0:
            if bits & 0x01:
                raise H5Error("big-endian integers are not supported")
            if size not in (1, 2, 4, 8):
                raise H5Error(f"{8 * size}-bit integers are not supported")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        raise H5Error(f"datatype class {cls} (version {version}) is not "
                      "supported (integers and IEEE floats only)")

    def _shape(self, body: int) -> tuple[int, ...]:
        version, ndim, flags = (int(self.buf[body + i]) for i in range(3))
        if version == 1:
            start = body + 8
        elif version == 2:
            start = body + 4
            if self.buf[body + 3] == 2:
                raise H5Error("null dataspaces are not supported")
        else:
            raise H5Error(f"dataspace version {version} is not supported")
        return tuple(self._uint(start + 8 * i, 8) for i in range(ndim))

    def read_dataset(self, addr: int) -> np.ndarray:
        dtype = shape = layout = None
        for mtype, body, _ in self.messages(addr):
            if mtype == 0x01:
                shape = self._shape(body)
            elif mtype == 0x03:
                dtype = self._dtype(body)
            elif mtype == 0x0B:
                raise H5Error("filtered datasets (filter pipeline, e.g. "
                              "gzip) are not supported")
            elif mtype == 0x08:
                layout = body
        if dtype is None or shape is None or layout is None:
            raise H5Error(f"dataset at {addr:#x} lacks a dataspace, datatype "
                          "or layout message")
        version, cls = int(self.buf[layout]), int(self.buf[layout + 1])
        if version != 3:
            raise H5Error(f"data layout version {version} is not supported "
                          "(3)")
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if cls == 0:                                         # compact
            size = self._uint(layout + 2, 2)
            start = layout + 4
        elif cls == 1:                                       # contiguous
            a = self._uint(layout + 2, 8)
            size = self._uint(layout + 10, 8)
            if a == UNDEFINED:                   # never written: fill 0
                return np.zeros(shape, dtype)
            start = self._addr(a)
        elif cls == 2:
            raise H5Error("chunked datasets are not supported")
        else:
            raise H5Error(f"data layout class {cls} is not supported")
        if size < n or start + n > self.buf.size:
            raise H5Error(f"dataset at {addr:#x}: {size} bytes stored, "
                          f"{n} needed")
        return np.array(self.buf[start:start + n].view(dtype).reshape(shape))

    def datasets(self):
        """Yield (path, array) of every dataset, depth first with each
        group's members in name order (h5py's ``visititems`` order)."""
        def walk(addr, prefix):
            kids = self._children(addr)
            if kids is None:
                yield prefix, self.read_dataset(addr)
                return
            for name, child in sorted(kids, key=lambda k: k[0].encode()):
                yield from walk(child, f"{prefix}/{name}" if prefix else name)

        yield from walk(self.root, "")


class H5Writer:
    """Writes a tree of groups (dicts) and datasets (numpy arrays) as an
    HDF5 file in the subset ``H5File`` reads: superblock version 0 with
    8-byte offsets and lengths, version-1 object headers, each group a
    symbol table (a one-level B-tree of symbol nodes, names in a local
    heap), each dataset contiguous. Members are stored in name order;
    the superblock's K values are set so that the largest group fits one
    B-tree node."""

    LEAF_K = 16                     # a symbol node holds 2 * LEAF_K entries

    def __init__(self, tree: dict):
        self.tree = tree
        self.buf = bytearray(96)    # the superblock, written last
        most = max(self._largest(tree), 1)
        nodes = -(-most // (2 * self.LEAF_K))
        self.node_k = max(16, -(-nodes // 2))

    @classmethod
    def _largest(cls, tree) -> int:
        if not isinstance(tree, dict):
            return 0
        return max([len(tree)] + [cls._largest(v) for v in tree.values()])

    def _alloc(self, data: bytes) -> int:
        self.buf += b"\0" * (-len(self.buf) % 8)
        pos = len(self.buf)
        self.buf += data
        return pos

    def _header(self, msgs) -> int:
        """A version-1 object header holding ``msgs`` [(type, body)]."""
        body = b""
        for mtype, m in msgs:
            m += b"\0" * (-len(m) % 8)
            body += struct.pack("<HHB3x", mtype, len(m), 0) + m
        return self._alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                       len(body)) + body)

    @staticmethod
    def _datatype(dt: np.dtype) -> bytes:
        if dt.newbyteorder("<") != dt:
            raise H5Error("big-endian arrays are not written")
        if dt.kind == "f":
            sign, exp_loc, exp_size, mant, bias = {
                2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
                8: (63, 52, 11, 52, 1023)}[dt.itemsize]
            return (struct.pack("<B3BI", 0x11, 0x20, sign, 0, dt.itemsize)
                    + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, exp_loc,
                                  exp_size, 0, mant, bias))
        if dt.kind in "iu":
            return (struct.pack("<B3BI", 0x10, 0x08 if dt.kind == "i" else 0,
                                0, 0, dt.itemsize)
                    + struct.pack("<HH", 0, 8 * dt.itemsize))
        raise H5Error(f"dtype {dt} is not written (integers and IEEE floats)")

    def _dataset(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        data = self._alloc(arr.tobytes())
        space = struct.pack("<BBBB4x", 1, arr.ndim, 0, 0) + b"".join(
            struct.pack("<Q", d) for d in arr.shape)
        layout = struct.pack("<BBQQ", 3, 1, data, arr.nbytes)
        return self._header([(0x01, space), (0x03, self._datatype(arr.dtype)),
                             (0x08, layout)])

    def _group(self, members: dict):
        """Write a group's members, then the group. Returns (object header
        address, symbol-table scratch pad: B-tree and heap addresses)."""
        entries = {}
        for name, value in members.items():
            if isinstance(value, dict):
                entries[name] = (1,) + self._group(value)
            else:
                entries[name] = (0, self._dataset(np.asarray(value)),
                                 b"\0" * 16)
        names = sorted(entries, key=lambda n: n.encode())
        heap_data = bytearray(8)                    # offset 0: ""
        offset = {}
        for n in names:
            offset[n] = len(heap_data)
            b = n.encode() + b"\0"
            heap_data += b + b"\0" * (-len(b) % 8)
        free = len(heap_data)                       # one free block, as
        heap_data += struct.pack("<QQ", 1, 16)      # libhdf5 leaves one
        data = self._alloc(bytes(heap_data))
        heap = self._alloc(b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(heap_data), free, data))
        per = 2 * self.LEAF_K
        snods = []
        for i in range(0, len(names), per):
            chunk = names[i:i + per]
            node = b"SNOD\x01\0" + struct.pack("<H", len(chunk))
            for n in chunk:
                cache, addr, scratch = entries[n]
                node += struct.pack("<QQI4x", offset[n], addr, cache) + scratch
            node += b"\0" * (8 + per * 40 - len(node))
            snods.append((self._alloc(node), offset[chunk[-1]]))
        if len(snods) > 2 * self.node_k:
            raise H5Error("group too large for one B-tree node")
        tree = b"TREE\0\0" + struct.pack("<HQQ", len(snods), UNDEFINED,
                                           UNDEFINED) + struct.pack("<Q", 0)
        for addr, last in snods:
            tree += struct.pack("<QQ", addr, last)
        k = self.node_k
        tree += b"\0" * (24 + (2 * k + 1) * 8 + 2 * k * 8 - len(tree))
        btree = self._alloc(tree)
        scratch = struct.pack("<QQ", btree, heap)
        return self._header([(0x11, scratch)]), scratch

    def write(self, path: str) -> str:
        root, scratch = self._group(self.tree)
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack(
            "<HHIQQQQ", self.LEAF_K, self.node_k, 0, 0, UNDEFINED,
            len(self.buf), UNDEFINED) + struct.pack("<QQI4x", 0, root, 1) \
            + scratch
        self.buf[:96] = sb
        with open(path, "wb") as f:
            f.write(self.buf)
        return path


def keras_layers(path: str) -> dict[str, dict[str, np.ndarray]]:
    """{layer: {weight name: array}} of a Keras weights file; the layer is
    the group that owns the datasets (``import_h5._keras_layers``)."""
    layers: dict[str, dict] = {}
    for name, arr in H5File(path).datasets():
        parts = name.split("/")
        if parts[0] == "model_weights":
            parts = parts[1:]
        layer = parts[-2] if len(parts) >= 2 else parts[0]
        layers.setdefault(layer, {})[parts[-1]] = arr
    return layers


# Keras weight name -> the kind of port tensor it writes
_KINDS = {"kernel": "kernel", "bias": "bias", "gamma": "scale",
          "beta": "bias_bn", "moving_mean": "mean", "moving_variance": "var"}


def _port_slots(module):
    """{port tensor name: (scope components, kind)}. The kinds are the JAX
    importer's: a BatchNorm's bias is ``bias_bn``."""
    from slam_maskrcnn_tpu_torch.models.backbone import BatchNorm

    out = {}
    named = list(module.named_parameters()) + list(module.named_buffers())
    for name, _ in named:
        scope, leaf = name.split(".")[:-1], name.split(".")[-1]
        if isinstance(module.get_submodule(".".join(scope)), BatchNorm):
            kind = {"scale": "scale", "bias": "bias_bn", "mean": "mean",
                    "var": "var"}[leaf]
        else:
            kind = {"weight": "kernel", "bias": "bias"}[leaf]
        out[name] = (tuple(scope), kind)
    return out


_KERAS_NAMES = {"kernel": "kernel:0", "bias": "bias:0", "scale": "gamma:0",
                "bias_bn": "beta:0", "mean": "moving_mean:0",
                "var": "moving_variance:0"}


def keras_weights(model) -> dict[str, dict[str, np.ndarray]]:
    """{layer: {Keras weight name: array}} of ``model.module``: the port's
    tensors in the Keras layout (Flax's, the deconv kernel as [kh, kw,
    cout, cin]), keyed by the reference's layer names."""
    from slam_maskrcnn_tpu_torch.models.weights import flax_array

    out: dict[str, dict] = {}
    for name, (scope, kind) in _port_slots(model.module).items():
        layer = scope[-1]
        value = flax_array(model.module, name)
        if kind == "kernel" and "deconv" in layer and value.ndim == 4:
            value = np.ascontiguousarray(np.transpose(value, (0, 1, 3, 2)))
        out.setdefault(layer, {})[_KERAS_NAMES[kind]] = value
    return out


def save_h5_weights(path: str, model) -> str:
    """Write ``model``'s weights as a Keras-layout .h5 (the JAX package's
    ``save_h5_weights``): ``model_weights/<layer>/<layer>/<name>:0``,
    float32 as the tensors hold them. ``load_h5_weights`` (strict) reads
    it back into the same architecture."""
    tree = {"model_weights": {layer: {layer: w} for layer, w in
                              keras_weights(model).items()}}
    return H5Writer(tree).write(str(path))


def load_h5_weights(path: str, model, exclude=None, strict: bool = False,
                    device=None):
    """Write a Keras weights .h5 into ``model.module`` by layer name and
    move it to ``device`` (default: the model's). ``exclude``: regexes of
    layer names to skip. ``strict``: raise unless every port tensor was
    written and every file layer consumed (excluded layers exempt on both
    sides). Returns the module."""
    from slam_maskrcnn_tpu_torch.models.weights import (flax_shape,
                                                        write_flax_arrays)

    exclude = [re.compile(p) for p in (exclude or [])]
    slots = _port_slots(model.module)
    arrays, loaded, skipped = {}, [], []
    for lname, weights in keras_layers(path).items():
        if any(p.search(lname) for p in exclude):
            continue
        ok = False
        for wname, value in weights.items():
            kind = _KINDS.get(wname.replace(":0", ""))
            if kind is None:
                continue
            if kind == "kernel" and "deconv" in lname and value.ndim == 4:
                value = np.transpose(value, (0, 1, 3, 2))
            hits = [n for n, (scope, k) in slots.items()
                    if k == kind and lname in scope]
            if len(hits) != 1:
                continue
            name = hits[0]
            want = flax_shape(model.module, name)
            if value.shape != want:
                raise ValueError(f"shape mismatch for {lname}/{kind}: h5 "
                                 f"{value.shape} vs model {want}")
            arrays[name] = value
            ok = True
        (loaded if ok else skipped).append(lname)
    if not loaded:
        raise ValueError(f"no layers matched between {path} and the model")
    if strict:
        unmatched = sorted(
            n for n, (scope, _) in slots.items() if n not in arrays
            and not any(p.search(c) for p in exclude for c in scope))
        problems = []
        if unmatched:
            problems.append(f"{len(unmatched)} model parameters not written "
                            f"by the file: {unmatched[:20]}"
                            f"{'...' if len(unmatched) > 20 else ''}")
        if skipped:
            problems.append(f"{len(skipped)} file layers not consumed by the "
                            f"model: {sorted(skipped)[:20]}"
                            f"{'...' if len(skipped) > 20 else ''}")
        if problems:
            raise ValueError(f"strict h5 import of {path} failed, a partial "
                             "name mismatch would run a half-initialized "
                             "network:\n  " + "\n  ".join(problems))
    dev = resolve_device(device if device is not None else model.device)
    return write_flax_arrays(model, arrays, dev)
