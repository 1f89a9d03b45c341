"""Minimal pure-NumPy HDF5 writer/reader (contiguous datasets, flat
root group).

The reference's mesh/field I/O is XDMF with HDF5 heavy data
(FEniCSx/mechanic2d/asym_elasto_damage_model.cc:152-164, 946-981).
This module needs no h5py: it implements the small subset
of the HDF5 file format needed for XDMF heavy data directly from the
spec: version-0 superblock, version-1 (un-checksummed) object headers,
v1 group B-tree + local heap + symbol-table nodes, and contiguous
dataset storage of fixed-width little-endian ints/floats. Files are
standard HDF5 — readable by h5py/ParaView — and round-trip through
:func:`read_hdf5` without any external dependency.

Layout written (all addresses absolute, base address 0):

    superblock (96 B) . root object header . local heap . B-tree node .
    SNOD . per-dataset object headers . raw data blocks
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_UNDEF = 0xFFFFFFFFFFFFFFFF
_SIG = b"\x89HDF\r\n\x1a\n"
_LEAF_K = 64  # symbols per SNOD = 2K (one SNOD: <=128 datasets/file)


def _align8(n: int) -> int:
    return -(-n // 8) * 8


def _msg(mtype: int, body: bytes) -> bytes:
    """Version-1 object-header message: type, size, flags, reserved."""
    body = body + b"\x00" * (_align8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages) -> bytes:
    """Version-1 object header (no checksum)."""
    body = b"".join(messages)
    # prefix: version, reserved, nmsgs, obj ref count, header size, pad4
    return struct.pack(
        "<BxHII4x", 1, len(messages), 1, len(body)
    ) + body


def _dtype_msg(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    if dt.kind == "f":
        # class 1 (float), version 1; IEEE little-endian
        size = dt.itemsize
        if size == 8:
            exp_loc, exp_sz, man_sz, bias = 52, 11, 52, 1023
        elif size == 4:
            exp_loc, exp_sz, man_sz, bias = 23, 8, 23, 127
        else:
            raise ValueError(f"unsupported float size {size}")
        bits0 = 0x20  # mantissa normalization: implied set (bits 4-5 = 2)
        bits1 = size * 8 - 1  # sign bit location
        body = struct.pack(
            "<BBBBI", (1 << 4) | 1, bits0, bits1, 0, size
        ) + struct.pack(
            "<HHBBBBI", 0, size * 8, exp_loc, exp_sz, 0, man_sz, bias
        )
        return _msg(0x0003, body)
    if dt.kind in "iu":
        size = dt.itemsize
        bits0 = 0x08 if dt.kind == "i" else 0x00  # signed flag
        body = struct.pack(
            "<BBBBI", (1 << 4) | 0, bits0, 0, 0, size
        ) + struct.pack("<HH", 0, size * 8)
        return _msg(0x0003, body)
    raise ValueError(f"unsupported dtype {dt}")


def _dataspace_msg(shape) -> bytes:
    body = struct.pack("<BBB5x", 1, len(shape), 0)
    for d in shape:
        body += struct.pack("<Q", d)
    return _msg(0x0001, body)


def _fill_msg() -> bytes:
    # v2: alloc time late(2), write time never(0), defined(0)
    return _msg(0x0005, struct.pack("<BBBB", 2, 2, 0, 0))


def _layout_msg(addr: int, nbytes: int) -> bytes:
    return _msg(0x0008, struct.pack("<BBQQ", 3, 1, addr, nbytes))


def _ste(name_off: int, oh_addr: int) -> bytes:
    """Symbol table entry, cache type 0 (40 bytes)."""
    return struct.pack("<QQI4x16x", name_off, oh_addr, 0)


def write_hdf5(path: str, datasets: Dict[str, np.ndarray]) -> None:
    """Write ``datasets`` (name -> array) as contiguous datasets in the
    root group of a new HDF5 file."""
    names = sorted(datasets)
    arrays = {
        n: np.ascontiguousarray(datasets[n]) for n in names
    }
    if len(names) > 2 * _LEAF_K:
        raise ValueError(
            f"flat writer holds <= {2*_LEAF_K} datasets per file"
        )

    # --- local heap data: offset 0 = empty string, then names ---------
    heap = bytearray(8)  # empty string slot (B-tree key 0)
    name_off = {}
    for n in names:
        name_off[n] = len(heap)
        nb = n.encode() + b"\x00"
        heap += nb + b"\x00" * (_align8(len(nb)) - len(nb))
    heap_data = bytes(heap)

    # --- fixed-size pieces, laid out back to front --------------------
    sb_size = 96
    # root group object header: one symbol-table message (addrs patched)
    root_oh_at = sb_size
    root_oh = _object_header([_msg(0x0011, struct.pack("<QQ", 0, 0))])
    heap_hdr_at = root_oh_at + len(root_oh)
    heap_hdr_size = 32
    heap_data_at = heap_hdr_at + heap_hdr_size
    btree_at = heap_data_at + len(heap_data)
    btree_size = 24 + 8 * (2 * _LEAF_K + 1) + 8 * (2 * _LEAF_K)
    snod_at = btree_at + btree_size
    snod_size = 8 + 2 * _LEAF_K * 40
    pos = snod_at + snod_size

    oh_at = {}
    oh_bytes = {}
    data_at = {}
    for n in names:
        a = arrays[n]
        oh = _object_header([
            _dataspace_msg(a.shape),
            _dtype_msg(a.dtype),
            _fill_msg(),
            _layout_msg(0, a.nbytes),  # addr patched below
        ])
        oh_at[n] = pos
        oh_bytes[n] = oh
        pos += len(oh)
    for n in names:
        data_at[n] = pos
        pos += _align8(arrays[n].nbytes)
    eof = pos

    # --- assemble -----------------------------------------------------
    buf = bytearray(eof)
    buf[0:sb_size] = (
        _SIG
        + struct.pack("<BBBxBBBxHHI", 0, 0, 0, 0, 8, 8, _LEAF_K, 16, 0)
        + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
        + _ste(0, root_oh_at)
    )
    root_oh = _object_header(
        [_msg(0x0011, struct.pack("<QQ", btree_at, heap_hdr_at))]
    )
    buf[root_oh_at : root_oh_at + len(root_oh)] = root_oh
    buf[heap_hdr_at : heap_hdr_at + heap_hdr_size] = (
        b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap_data), 1, heap_data_at
        )
    )
    buf[heap_data_at : heap_data_at + len(heap_data)] = heap_data
    bt = bytearray(btree_size)
    bt[0:24] = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
    # key0 (empty string), child0 (the SNOD), key1 (largest name)
    key1 = name_off[names[-1]] if names else 0
    bt[24:48] = struct.pack("<QQQ", 0, snod_at, key1)
    buf[btree_at : btree_at + btree_size] = bytes(bt)
    sn = bytearray(snod_size)
    sn[0:8] = b"SNOD" + struct.pack("<BxH", 1, len(names))
    for i, n in enumerate(names):
        sn[8 + 40 * i : 48 + 40 * i] = _ste(name_off[n], oh_at[n])
    buf[snod_at : snod_at + snod_size] = bytes(sn)
    for n in names:
        a = arrays[n]
        oh = _object_header([
            _dataspace_msg(a.shape),
            _dtype_msg(a.dtype),
            _fill_msg(),
            _layout_msg(data_at[n], a.nbytes),
        ])
        buf[oh_at[n] : oh_at[n] + len(oh)] = oh
        buf[data_at[n] : data_at[n] + a.nbytes] = a.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(buf))


# ---------------------------------------------------------------------------
# reader


def _parse_messages(buf: bytes, at: int):
    ver, nmsgs, _refs, hsize = struct.unpack_from("<BxHII", buf, at)
    if ver != 1:
        raise NotImplementedError(f"object header version {ver}")
    out = []
    pos = at + 16
    end = pos + hsize
    for _ in range(nmsgs):
        if pos >= end:
            break
        mtype, msize, _flags = struct.unpack_from("<HHB3x", buf, pos)
        body = buf[pos + 8 : pos + 8 + msize]
        if mtype == 0x0010:  # continuation
            off, length = struct.unpack_from("<QQ", body, 0)
            pos = off
            end = off + length
            continue
        out.append((mtype, body))
        pos += 8 + msize
    return out


def _parse_dtype(body: bytes) -> np.dtype:
    cv, b0, _b1, _b2, size = struct.unpack_from("<BBBBI", body, 0)
    cls = cv & 0x0F
    if cls in (0, 1) and (b0 & 0x01):
        # byte-order bit set: big-endian data — fail loudly like the
        # other unsupported-feature guards instead of silently
        # misreading the bytes as little-endian (ADVICE r4)
        raise NotImplementedError("big-endian HDF5 datatype")
    if cls == 1:
        return np.dtype(f"<f{size}")
    if cls == 0:
        return np.dtype(f"<{'i' if b0 & 0x08 else 'u'}{size}")
    raise NotImplementedError(f"datatype class {cls}")


def _read_dataset(buf: bytes, oh_addr: int) -> np.ndarray:
    shape = dtype = None
    addr = nbytes = None
    for mtype, body in _parse_messages(buf, oh_addr):
        if mtype == 0x0001:
            ver, rank = struct.unpack_from("<BB", body, 0)
            off = 8 if ver == 1 else 4
            shape = struct.unpack_from(f"<{rank}Q", body, off)
        elif mtype == 0x0003:
            dtype = _parse_dtype(body)
        elif mtype == 0x0008:
            ver, cls = struct.unpack_from("<BB", body, 0)
            if ver != 3 or cls != 1:
                raise NotImplementedError(
                    f"layout version {ver} class {cls}"
                )
            addr, nbytes = struct.unpack_from("<QQ", body, 2)
    a = np.frombuffer(buf[addr : addr + nbytes], dtype=dtype)
    return a.reshape(shape)


def read_hdf5(path: str) -> Dict[str, np.ndarray]:
    """Read all root-group contiguous datasets of an HDF5 file written
    by :func:`write_hdf5` (or any file within the same subset)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError("not an HDF5 file")
    sb_ver = buf[8]
    if sb_ver != 0:
        raise NotImplementedError(f"superblock version {sb_ver}")
    root_oh = struct.unpack_from("<Q", buf, 24 + 32 + 8)[0]
    btree_at = heap_at = None
    for mtype, body in _parse_messages(buf, root_oh):
        if mtype == 0x0011:
            btree_at, heap_at = struct.unpack_from("<QQ", body, 0)
    if btree_at is None:
        return {}
    heap_data_at = struct.unpack_from("<Q", buf, heap_at + 24)[0]

    def heap_str(off):
        end = buf.index(b"\x00", heap_data_at + off)
        return buf[heap_data_at + off : end].decode()

    out: Dict[str, np.ndarray] = {}

    def walk_btree(at):
        assert buf[at : at + 4] == b"TREE"
        _ntype, level, n_used = struct.unpack_from("<BBH", buf, at + 4)
        pos = at + 24 + 8  # skip key0
        for _ in range(n_used):
            child = struct.unpack_from("<Q", buf, pos)[0]
            pos += 16  # child + next key
            if level > 0:
                walk_btree(child)
            else:
                assert buf[child : child + 4] == b"SNOD"
                nsym = struct.unpack_from("<H", buf, child + 6)[0]
                for i in range(nsym):
                    noff, oh = struct.unpack_from(
                        "<QQ", buf, child + 8 + 40 * i
                    )
                    out[heap_str(noff)] = _read_dataset(buf, oh)

    walk_btree(btree_at)
    return out
