"""Read-only HDF5 reader for Keras weight files, in numpy and ``struct``.

The port's stand-in for ``h5py``, which the hosts that run the port need
not have.  It reads the part of HDF5 that h5py writes by default
(``libver="earliest"``) and that Keras 2.1-2.x and TF 2.x legacy ``.h5``
saving produce:

- superblock versions 0 and 1, and versions 2 and 3 (version-2 object
  headers);
- object headers of version 1 and version 2 (``OHDR`` / ``OCHK``,
  checksums not verified), with continuation messages;
- symbol-table groups (v1 B-tree of ``SNOD`` nodes and a local heap) and
  compact link storage (Link messages);
- dataspaces (scalar, null, simple), fixed-point and IEEE float data in
  either byte order, fixed-length strings and variable-length strings
  (global heap);
- attribute messages v1-v3; compact and contiguous data layouts (v3, v4).

Anything else (dense link or attribute storage, chunked layouts, filter
pipelines, compound or array types, shared messages) raises
``KerasImportError`` naming what it met.  Every offset is bound-checked,
so a damaged file raises the same error rather than an ``IndexError`` or
a hang.  Such a file can still be converted to the native checkpoint
(``<stem>.npz``) with the JAX package, which reads it through h5py; the
registry then loads the npz.

API: what the Keras import uses, ``File(path)`` with ``attrs``,
``keys()``, ``in`` and ``[path]``; groups iterate their members sorted by
name, as h5py does, and datasets convert to numpy arrays
(``np.array(ds)``).
"""

from __future__ import annotations

import functools
import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
CONVERT_HINT = ("convert the file with the JAX package "
                "(inaspeechsegmenter_tpu.models.load_patch_model writes the "
                "native <stem>.npz beside it), then load the npz")
ZERO_FILL_LIMIT = 1 << 30     # bytes of a dataset with no storage


class KerasImportError(ValueError):
    pass


def _guarded(fn):
    """Re-raise the low-level errors a damaged file can provoke as
    ``KerasImportError``; a missing member stays a ``KeyError``."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except (KerasImportError, KeyError):
            raise
        except (ValueError, IndexError, OverflowError, struct.error,
                RecursionError, TypeError) as exc:
            raise KerasImportError(
                f"{self._r.path}: malformed HDF5 ({exc!r})") from exc
    return wrapper


class _Reader:
    """The file's bytes and the format's low-level structures."""

    def __init__(self, buf, path):
        self.buf = buf
        self.path = path
        self._headers = {}
        self._gcols = {}
        self.root, self.root_symtab = self._superblock()

    # -- bound-checked primitives -----------------------------------------
    def fail(self, what):
        return KerasImportError(f"{self.path}: {what}")

    def unsupported(self, what):
        return KerasImportError(
            f"{self.path}: {what} is not supported by the port's HDF5 "
            f"reader; {CONVERT_HINT}")

    def bytes(self, pos, n):
        if pos < 0 or n < 0 or pos + n > len(self.buf):
            raise self.fail(f"truncated file: {n} bytes at offset {pos} "
                            f"past its end ({len(self.buf)} bytes)")
        return self.buf[pos:pos + n]

    def u(self, pos, n):
        return int.from_bytes(self.bytes(pos, n), "little")

    def addr(self, pos):
        """An address field -> absolute offset, or None if undefined."""
        a = self.u(pos, self.O)
        if a == (1 << (8 * self.O)) - 1:
            return None
        return self.base + a

    def signature(self, pos, sig):
        if self.bytes(pos, len(sig)) != sig:
            raise self.fail(f"expected {sig!r} at offset {pos}")

    # -- superblock ---------------------------------------------------------
    def _superblock(self):
        sb = 0
        while self.buf[sb:sb + 8] != SIGNATURE:
            sb = 512 if sb == 0 else 2 * sb
            if sb + 8 > len(self.buf):
                raise self.fail("not an HDF5 file (no superblock signature)")
        version = self.u(sb + 8, 1)
        self.base = 0
        if version in (0, 1):
            self.O, self.L = self.u(sb + 13, 1), self.u(sb + 14, 1)
            self._check_sizes()
            p = sb + 24 + (4 if version == 1 else 0)
            self.base = self.u(p, self.O)
            entry = p + 4 * self.O
            root = self.addr(entry + self.O)
            symtab = None
            if self.u(entry + 2 * self.O, 4) == 1:
                scratch = entry + 2 * self.O + 8
                symtab = (self.addr(scratch), self.addr(scratch + self.O))
            return root, symtab
        if version in (2, 3):
            self.O, self.L = self.u(sb + 9, 1), self.u(sb + 10, 1)
            self._check_sizes()
            p = sb + 12
            self.base = self.u(p, self.O)
            return self.addr(p + 3 * self.O), None
        raise self.unsupported(f"superblock version {version}")

    def _check_sizes(self):
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise self.fail(f"bad offset/length sizes {self.O}/{self.L}")

    # -- object headers -----------------------------------------------------
    def header(self, addr):
        """Object header at ``addr`` -> [(type, flags, body offset, size)]."""
        if addr is None:
            raise self.fail("link to an undefined address")
        if addr not in self._headers:
            if self.bytes(addr, 4) == b"OHDR":
                self._headers[addr] = self._header_v2(addr)
            elif self.u(addr, 1) == 1:
                self._headers[addr] = self._header_v1(addr)
            else:
                raise self.fail(f"no object header at offset {addr}")
        return self._headers[addr]

    def _walk_blocks(self, first, parse):
        msgs, seen = [], set()
        blocks = [first]
        while blocks:
            start, length = blocks.pop(0)
            if start in seen or len(seen) > 4096:
                raise self.fail("object header continuation loop")
            seen.add(start)
            for m in parse(start, length):
                msgs.append(m)
                if m[0] == 0x10:                   # continuation
                    blocks.append((self.addr(m[2]),
                                   self.u(m[2] + self.O, self.L)))
        return msgs

    def _header_v1(self, addr):
        size = self.u(addr + 8, 4)

        def parse(start, length):
            if start is None:
                raise self.fail("continuation to an undefined address")
            end = start + length
            self.bytes(start, length)
            out, p = [], start
            while p + 8 <= end:
                mtype, msize = self.u(p, 2), self.u(p + 2, 2)
                if p + 8 + msize > end:
                    raise self.fail(f"object header message past its block "
                                    f"at offset {p}")
                out.append((mtype, self.u(p + 4, 1), p + 8, msize))
                p += 8 + msize
            return out
        return self._walk_blocks((addr + 16, size), parse)

    def _header_v2(self, addr):
        version, flags = self.u(addr + 4, 1), self.u(addr + 5, 1)
        if version != 2:
            raise self.unsupported(f"object header version {version}")
        p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        nsize = 1 << (flags & 3)
        chunk0 = self.u(p, nsize)
        hdr = 6 if flags & 0x04 else 4

        def parse(start, length):
            if start is None:
                raise self.fail("continuation to an undefined address")
            if start != p + nsize:
                self.signature(start, b"OCHK")
                start, length = start + 4, length - 8
            end = start + length
            self.bytes(start, max(length, 0))
            out, q = [], start
            while q + hdr <= end:
                mtype, msize = self.u(q, 1), self.u(q + 1, 2)
                if q + hdr + msize > end:
                    raise self.fail(f"object header message past its block "
                                    f"at offset {q}")
                out.append((mtype, self.u(q + 3, 1), q + hdr, msize))
                q += hdr + msize
            return out
        return self._walk_blocks((p + nsize, chunk0), parse)

    # -- groups -------------------------------------------------------------
    def symbol_table(self, btree, heap):
        """Members of a symbol-table group -> {name: object address}."""
        if heap is None:
            raise self.fail("symbol table without a local heap")
        self.signature(heap, b"HEAP")
        data_size = self.u(heap + 8, self.L)
        data = self.addr(heap + 8 + 2 * self.L)
        if data is None:
            raise self.fail("local heap without a data segment")
        names = self.bytes(data, data_size)
        out, seen = {}, set()

        def name_at(off):
            end = names.find(b"\0", off)
            if off >= len(names) or end < 0:
                raise self.fail(f"link name offset {off} outside the heap")
            return self.text(names[off:end])

        def node(addr, depth):
            if addr is None or addr in seen or depth > 64:
                raise self.fail("malformed group B-tree")
            seen.add(addr)
            self.signature(addr, b"TREE")
            if self.u(addr + 4, 1) != 0:
                raise self.fail("group B-tree with a non-group node")
            level, entries = self.u(addr + 5, 1), self.u(addr + 6, 2)
            p = addr + 8 + 2 * self.O
            for i in range(entries):
                child = self.addr(p + (i + 1) * self.L + i * self.O)
                if level > 0:
                    node(child, depth + 1)
                else:
                    snod(child)

        def snod(addr):
            if addr is None or addr in seen:
                raise self.fail("malformed group B-tree leaf")
            seen.add(addr)
            self.signature(addr, b"SNOD")
            entry = 2 * self.O + 24
            for i in range(self.u(addr + 6, 2)):
                e = addr + 8 + i * entry
                out[name_at(self.u(e, self.O))] = self.addr(e + self.O)

        if btree is not None:
            node(btree, 0)
        return out

    def link(self, p, size):
        """A Link message -> (name, object address) of a hard link."""
        end = p + size
        version, flags = self.u(p, 1), self.u(p + 1, 1)
        if version != 1:
            raise self.unsupported(f"link message version {version}")
        q = p + 2
        ltype = 0
        if flags & 0x08:
            ltype = self.u(q, 1)
            q += 1
        q += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        nsize = 1 << (flags & 3)
        nlen = self.u(q, nsize)
        q += nsize
        if q + nlen + (self.O if ltype == 0 else 0) > end:
            raise self.fail("link message past its end")
        name = self.text(self.bytes(q, nlen))
        if ltype != 0:
            raise self.unsupported(f"soft or external link {name!r}")
        return name, self.addr(q + nlen)

    def check_compact(self, p, what):
        """Link Info (0x02) or Attribute Info (0x15) message: refuse dense
        storage (a fractal heap)."""
        flags = self.u(p + 1, 1)
        q = p + 2 + ((8 if what == "link" else 2) if flags & 1 else 0)
        if self.addr(q) is not None:
            raise self.unsupported(f"dense {what} storage (fractal heap)")

    def text(self, raw):
        try:
            return bytes(raw).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise self.fail(f"name is not UTF-8 ({exc})") from exc

    # -- types, spaces, values ---------------------------------------------
    def datatype(self, p, size):
        """Datatype message -> (kind, numpy dtype, element size, pad)."""
        if size < 8:
            raise self.fail("datatype message too short")
        cls = self.u(p, 1) & 0x0F
        bits = self.u(p + 1, 3)
        esize = self.u(p + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0 and esize in (1, 2, 4, 8):
            kind = "i" if bits & 0x08 else "u"
            return "num", np.dtype(f"{order}{kind}{esize}"), esize, 0
        if cls == 1 and esize in (2, 4, 8) and not bits & 0x40:
            return "num", np.dtype(f"{order}f{esize}"), esize, 0
        if cls == 3 and esize > 0:
            return "str", np.dtype(f"S{esize}"), esize, bits & 0x0F
        if cls == 9 and bits & 0x0F == 1:
            return "vstr", np.dtype(object), 4 + self.O + 4, 0
        names = {0: "integer", 1: "float", 2: "time", 3: "string",
                 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                 8: "enum", 9: "variable-length sequence", 10: "array"}
        raise self.unsupported(
            f"datatype {names.get(cls, cls)} of size {esize}")

    def dataspace(self, p):
        """Dataspace message -> shape tuple, or None for a null space."""
        version, rank = self.u(p, 1), self.u(p + 1, 1)
        if version == 1:
            q, null = p + 8, False
        elif version == 2:
            q, null = p + 4, self.u(p + 3, 1) == 2
        else:
            raise self.unsupported(f"dataspace version {version}")
        if null:
            return None
        return tuple(self.u(q + i * self.L, self.L) for i in range(rank))

    def values(self, raw, kind, dtype, esize, pad, shape):
        """Raw element bytes -> numpy array of ``shape``."""
        count = int(np.prod(shape, dtype=object)) if shape else 1
        if kind == "num":
            return np.frombuffer(raw, dtype, count).reshape(shape).copy()
        items = []
        for i in range(count):
            e = raw[i * esize:(i + 1) * esize]
            if kind == "vstr":
                items.append(self.text(self.vlen(e)))
            elif pad == 0:                          # null-terminated
                items.append(bytes(e).split(b"\0", 1)[0])
            elif pad == 2:                          # space-padded
                items.append(bytes(e).rstrip(b" "))
            else:                                   # null-padded
                items.append(bytes(e).rstrip(b"\0"))
        return np.array(items, dtype).reshape(shape)

    def vlen(self, elem):
        """(length, collection address, index) -> the global-heap bytes."""
        n = int.from_bytes(elem[:4], "little")
        coll = self.addr_of(elem[4:4 + self.O])
        idx = int.from_bytes(elem[4 + self.O:8 + self.O], "little")
        if n == 0:
            return b""
        objs = self.gcol(coll)
        if idx not in objs or n > len(objs[idx]):
            raise self.fail(f"global heap object {idx} missing or short")
        return objs[idx][:n]

    def addr_of(self, raw):
        a = int.from_bytes(raw, "little")
        return None if a == (1 << (8 * self.O)) - 1 else self.base + a

    def gcol(self, addr):
        if addr is None:
            raise self.fail("global heap at an undefined address")
        if addr not in self._gcols:
            self.signature(addr, b"GCOL")
            end = addr + self.u(addr + 8, self.L)
            self.bytes(addr, end - addr)
            objs, p = {}, addr + 8 + self.L
            while p + 8 + self.L <= end:
                idx = self.u(p, 2)
                if idx == 0:                         # free space
                    break
                n = self.u(p + 8, self.L)
                objs[idx] = self.bytes(p + 8 + self.L, n)
                p += 8 + self.L + ((n + 7) & ~7)
            self._gcols[addr] = objs
        return self._gcols[addr]

    def attribute(self, p, size):
        """Attribute message -> (name, value) as h5py returns it."""
        end = p + size
        version = self.u(p, 1)
        nsz, tsz, ssz = self.u(p + 2, 2), self.u(p + 4, 2), self.u(p + 6, 2)
        q = p + 8

        def pad(n):
            return (n + 7) & ~7 if version == 1 else n
        if version in (2, 3):
            if self.u(p + 1, 1) & 0x03:
                raise self.unsupported("shared attribute datatype/dataspace")
            q += 1 if version == 3 else 0
        elif version != 1:
            raise self.unsupported(f"attribute message version {version}")
        name = self.text(bytes(self.bytes(q, nsz)).rstrip(b"\0"))
        q += pad(nsz)
        dt = self.datatype(q, tsz)
        q += pad(tsz)
        shape = self.dataspace(q)
        q += pad(ssz)
        kind, dtype, esize, spad = dt
        if shape is None:
            return name, np.empty((0,), dtype)
        count = int(np.prod(shape, dtype=object)) if shape else 1
        if q + count * esize > end:
            raise self.fail(f"attribute {name!r} data past its message")
        arr = self.values(self.bytes(q, count * esize), kind, dtype, esize,
                          spad, shape)
        return name, (arr[()] if shape == () else arr)


class _Object:
    """A group or dataset: its object header's messages and attributes."""

    def __init__(self, reader, addr, name, ancestors=()):
        if addr in ancestors:
            raise reader.fail(f"hard-link cycle at {name!r}")
        self._r = reader
        self._addr = addr
        self._ancestors = ancestors + (addr,)
        self.name = name
        self._msgs = reader.header(addr)

    def _find(self, mtype):
        return [m for m in self._msgs if m[0] == mtype]

    @functools.cached_property
    def attrs(self):
        return _Attributes(self)


class _Attributes:
    """The ``attrs`` of a group or dataset (compact storage only)."""

    def __init__(self, obj):
        self._obj = obj
        self._r = obj._r

    @functools.cached_property
    @_guarded
    def _items(self):
        for _, _, p, _ in self._obj._find(0x15):
            self._r.check_compact(p, "attribute")
        out = {}
        for _, flags, p, size in self._obj._find(0x0C):
            if flags & 0x02:
                raise self._r.unsupported("shared attribute message")
            name, value = self._r.attribute(p, size)
            out[name] = value
        return {k: out[k] for k in sorted(out, key=str.encode)}

    def keys(self):
        return list(self._items)

    def __contains__(self, name):
        return name in self._items

    def __getitem__(self, name):
        return self._items[name]

    def get(self, name, default=None):
        return self._items.get(name, default)

    def __iter__(self):
        return iter(self._items)


class Dataset(_Object):
    """A dataset; ``np.array(ds)`` reads it."""

    @functools.cached_property
    @_guarded
    def _layout(self):
        def one(mtype, what):
            found = self._find(mtype)
            if not found:
                raise self._r.fail(f"dataset {self.name!r} has no {what}")
            if found[0][1] & 0x02:
                raise self._r.unsupported(f"shared {what} of {self.name!r}")
            return found[0]
        _, _, tp, tsz = one(0x03, "datatype")
        _, _, sp, _ = one(0x01, "dataspace")
        return self._r.datatype(tp, tsz), self._r.dataspace(sp)

    @_guarded
    def _read(self):
        r = self._r
        (kind, dtype, esize, pad), shape = self._layout
        if shape is None:
            return np.empty((0,), dtype)
        if self._find(0x0B):
            raise r.unsupported(f"filter pipeline (compression) on dataset "
                                f"{self.name!r}")
        count = int(np.prod(shape, dtype=object)) if shape else 1
        nbytes = count * esize
        _, _, p, size = self._find(0x08)[0]
        version, cls = r.u(p, 1), r.u(p + 1, 1)
        if version not in (3, 4):
            raise r.unsupported(f"data layout message version {version}")
        if cls == 0:                                   # compact
            if r.u(p + 2, 2) < nbytes or p + 4 + nbytes > p + size:
                raise r.fail(f"compact dataset {self.name!r} is short")
            raw = r.bytes(p + 4, nbytes)
        elif cls == 1:                                 # contiguous
            addr = r.addr(p + 2)
            if addr is None:
                if nbytes > ZERO_FILL_LIMIT:
                    raise r.fail(f"dataset {self.name!r} of {nbytes} bytes "
                                 "has no storage")
                raw = bytes(nbytes)
            else:
                raw = r.bytes(addr, nbytes)
        else:
            raise r.unsupported(
                f"{'chunked' if cls == 2 else 'virtual'} layout of dataset "
                f"{self.name!r}")
        return r.values(raw, kind, dtype, esize, pad, shape)

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        return arr if dtype is None else arr.astype(dtype)


class Group(_Object):
    """A group: members by name, iterated sorted by name as h5py does."""

    def __init__(self, reader, addr, name, ancestors=(), file=None,
                 cached_symtab=None):
        super().__init__(reader, addr, name, ancestors)
        self._file = file if file is not None else self
        self._cached_symtab = cached_symtab

    @functools.cached_property
    @_guarded
    def _links(self):
        r = self._r
        symtab = self._find(0x11)
        if symtab:
            p = symtab[0][2]
            links = r.symbol_table(r.addr(p), r.addr(p + r.O))
        elif self._cached_symtab is not None:
            links = r.symbol_table(*self._cached_symtab)
        else:
            for _, _, p, _ in self._find(0x02):
                r.check_compact(p, "link")
            links = dict(r.link(p, size) for _, _, p, size in self._find(0x06))
        return {k: links[k] for k in sorted(links, key=str.encode)}

    def keys(self):
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    @_guarded
    def __getitem__(self, path):
        if not isinstance(path, str):
            raise TypeError(f"member names are str, not {type(path)}")
        node = self._file if path.startswith("/") else self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group):
                raise KeyError(path)
            node = node._child(part)
        return node

    def _child(self, name):
        if name not in self._links:
            raise KeyError(name)
        addr = self._links[name]
        full = (self.name.rstrip("/") + "/" + name)
        msgs = self._r.header(addr)
        if any(m[0] == 0x08 for m in msgs):
            return Dataset(self._r, addr, full, self._ancestors)
        return Group(self._r, addr, full, self._ancestors, self._file)


class File(Group):
    """An HDF5 file read whole into memory (Keras weight files are small).

    Usable as a context manager, like ``h5py.File(path, "r")``."""

    def __init__(self, path, mode="r"):
        if mode != "r":
            raise ValueError("the port's HDF5 reader is read-only")
        with open(path, "rb") as fh:
            buf = fh.read()
        try:
            reader = _Reader(buf, path)
            super().__init__(reader, reader.root, "/",
                             cached_symtab=reader.root_symtab)
        except KerasImportError:
            raise
        except (ValueError, IndexError, OverflowError, struct.error) as exc:
            raise KerasImportError(f"{path}: malformed HDF5 ({exc!r})") \
                from exc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
