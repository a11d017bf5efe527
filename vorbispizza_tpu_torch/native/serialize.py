"""Setup-header serialization for the native front end.

Flattens a parsed SetupHeader (setup/header.py) into the binary blob
consumed by frontend.cpp's parse_setup. All fields little-endian u32/i32/f32
(4-byte aligned by construction)."""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x56505445  # 'VPTE'
VERSION = 1


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u32(self, *vals: int) -> None:
        self.parts.append(struct.pack(f"<{len(vals)}I", *[v & 0xFFFFFFFF for v in vals]))

    def i32(self, *vals: int) -> None:
        self.parts.append(struct.pack(f"<{len(vals)}i", *vals))

    def arr_i32(self, a) -> None:
        self.parts.append(np.ascontiguousarray(a, dtype=np.int32).tobytes())

    def arr_u32(self, a) -> None:
        self.parts.append(np.ascontiguousarray(a, dtype=np.uint32).tobytes())

    def arr_f32(self, a) -> None:
        self.parts.append(np.ascontiguousarray(a, dtype=np.float32).tobytes())

    def blob(self) -> bytes:
        return b"".join(self.parts)


def serialize_setup(setup, ident) -> bytes:
    w = _Writer()
    w.u32(MAGIC, VERSION)
    w.u32(ident.channels, ident.blocksizes[0], ident.blocksizes[1], setup.mode_bits)

    cb_index = {id(cb): i for i, cb in enumerate(setup.codebooks)}
    w.u32(len(setup.codebooks))
    for cb in setup.codebooks:
        w.u32(cb.dimensions, cb.entries, cb.max_len, 1 if cb.has_lookup else 0)
        w.arr_i32(cb._prefix_sym)
        w.arr_i32(cb._prefix_len)
        flat = [
            (length, bits, sym)
            for length, d in cb._overflow
            for bits, sym in sorted(d.items())
        ]
        w.u32(len(flat))
        if flat:
            w.arr_u32(np.asarray(flat, dtype=np.uint32).reshape(-1))
        if cb.has_lookup:
            w.arr_f32(cb.lookup_table)

    fl_index = {id(f): i for i, f in enumerate(setup.floors)}
    w.u32(len(setup.floors))
    for f in setup.floors:
        w.u32(f.floor_type)
        if f.floor_type == 0:
            w.u32(
                f.order, f.amplitude_bits, f.amplitude_offset,
                f._book_bits, len(f.books),
            )
            w.arr_u32(np.asarray([cb_index[id(b)] for b in f.books]))
        else:
            w.u32(len(f.partition_classes))
            w.arr_u32(np.asarray(f.partition_classes))
            n_classes = len(f.class_dims)
            w.u32(n_classes)
            for c in range(n_classes):
                w.u32(f.class_dims[c], f.class_subclasses[c])
                mb = f.class_masterbooks[c]
                w.i32(cb_index[id(mb)] if mb is not None else -1)
                w.arr_i32(
                    np.asarray(
                        [cb_index[id(b)] if b is not None else -1
                         for b in f.subclass_books[c]]
                    )
                )
            w.u32(f.multiplier, f.range, f._y_bits, f.n_posts)
            w.arr_i32(f.xs)
            w.arr_i32(f.low_neighbor)
            w.arr_i32(f.high_neighbor)

    res_index = {id(r): i for i, r in enumerate(setup.residues)}
    w.u32(len(setup.residues))
    for r in setup.residues:
        w.u32(
            r.residue_type, r.begin, r.end, r.partition_size,
            r.classifications, cb_index[id(r.classbook)],
        )
        w.arr_u32(np.asarray(r.cascades))
        w.arr_i32(
            np.asarray(
                [
                    cb_index[id(b)] if b is not None else -1
                    for row in r.books
                    for b in row
                ]
            )
        )

    w.u32(len(setup.mappings))
    for m in setup.mappings:
        w.u32(m.submaps, len(m.coupling_steps))
        if m.coupling_steps:
            w.arr_u32(np.asarray(m.coupling_steps, dtype=np.uint32).reshape(-1))
        w.arr_u32(np.asarray(m.mux))
        w.arr_u32(np.asarray([fl_index[id(f)] for f in m.submap_floor]))
        w.arr_u32(np.asarray([res_index[id(r)] for r in m.submap_residue]))

    w.u32(len(setup.modes))
    for mo in setup.modes:
        w.u32(1 if mo.block_flag else 0, mo.mapping_idx)
    return w.blob()
