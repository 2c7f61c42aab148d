"""Minimal HDF4 SD writer (HLS-v1-style files) for tests.

Emits the same structures the reader consumes: NT/SDD/NDG scientific data
sets with optional DEFLATE (SPECIAL_COMP) or chunked+DEFLATE
(SPECIAL_CHUNKED) storage, 'Var0.0' Vgroups with 'Attr0.0' attribute
Vdatas, global attributes, and an HDF-EOS StructMetadata.0 grid block.
"""

import struct

import numpy as np
import zlib

from proteus_jax.io import hdf4 as H

DFNT_CHAR8 = 4


class Hdf4Writer:
    def __init__(self):
        self._elements = []   # (tag, ref, bytes)
        self._next_ref = 1

    def _ref(self):
        r = self._next_ref
        self._next_ref += 1
        return r

    def _add(self, tag, ref, data):
        self._elements.append((tag, ref, bytes(data)))
        return ref

    # -- low-level records -----------------------------------------------------

    def _nt(self, dtype):
        code = H._DTYPE_NT[np.dtype(dtype)]
        ref = self._ref()
        width = np.dtype(dtype).itemsize * 8
        self._add(H.DFTAG_NT, ref, bytes([1, code, width, 0]))
        return ref, code

    def _vdata(self, name, klass, field_name, nt_code, order, nvert,
               payload):
        ref = self._ref()
        isize = order * self._nt_size(nt_code)
        head = struct.pack('>HIHH', 0, nvert, isize, 1)
        head += struct.pack('>H', nt_code)
        head += struct.pack('>H', isize)
        head += struct.pack('>H', 0)
        head += struct.pack('>H', order)
        head += struct.pack('>H', len(field_name)) + \
            field_name.encode('latin-1')
        head += struct.pack('>H', len(name)) + name.encode('latin-1')
        head += struct.pack('>H', len(klass)) + klass.encode('latin-1')
        head += struct.pack('>HHH', 0, 0, 3)
        self._add(H.DFTAG_VH, ref, head)
        self._add(H.DFTAG_VS, ref, payload)
        return ref

    @staticmethod
    def _nt_size(code):
        return {3: 1, 4: 1, 5: 4, 6: 8, 20: 1, 21: 1, 22: 2, 23: 2,
                24: 4, 25: 4}[code]

    def attr_vdata(self, name, value):
        if isinstance(value, str):
            payload = value.encode('latin-1')
            return self._vdata(name, 'Attr0.0', 'VALUES', DFNT_CHAR8,
                               len(payload), 1, payload)
        arr = np.atleast_1d(np.asarray(value))
        code = H._DTYPE_NT[arr.dtype]
        payload = arr.astype(arr.dtype.newbyteorder('>')).tobytes()
        return self._vdata(name, 'Attr0.0', 'VALUES', code, len(arr), 1,
                           payload)

    def _vgroup(self, name, klass, members):
        ref = self._ref()
        data = struct.pack('>H', len(members))
        data += b''.join(struct.pack('>H', t) for t, _ in members)
        data += b''.join(struct.pack('>H', r) for _, r in members)
        data += struct.pack('>H', len(name)) + name.encode('latin-1')
        data += struct.pack('>H', len(klass)) + klass.encode('latin-1')
        data += struct.pack('>HHH', 0, 0, 3)
        self._add(H.DFTAG_VG, ref, data)
        return ref

    # -- public API --------------------------------------------------------------

    def add_global_attr(self, name, value):
        self.attr_vdata(name, value)

    def _add_linked(self, tag, ref, data, blk_len=1024,
                    refs_per_table=16):
        """Store ``data`` as a linked-block special element in the HDF
        4.2 hblocks layout: the special header points at a block TABLE
        ([u16 next_table][u16 block_ref x refs_per_table], zero refs =
        unused slots) whose entries name DFTAG_LINKED data blocks."""
        blocks = [data[i:i + blk_len]
                  for i in range(0, len(data), blk_len)] or [b'']
        block_refs = []
        for b in blocks:
            r = self._ref()
            self._add(H.DFTAG_LINKED, r, b)
            block_refs.append(r)
        tables = [block_refs[i:i + refs_per_table]
                  for i in range(0, len(block_refs), refs_per_table)]
        table_refs = [self._ref() for _ in tables]
        for i, (tbl, tref) in enumerate(zip(tables, table_refs)):
            nxt = table_refs[i + 1] if i + 1 < len(tables) else 0
            padded = tbl + [0] * (refs_per_table - len(tbl))
            self._add(H.DFTAG_LINKED, tref,
                      struct.pack('>H' + 'H' * refs_per_table, nxt,
                                  *padded))
        header = struct.pack('>hiiiH', H.SPECIAL_LINKED, len(data),
                             blk_len, refs_per_table, table_refs[0])
        self._add(tag | H.EXT_TAG_BIT, ref, header)

    def add_sds(self, name, array, attrs=None, compress=True,
                chunked=False, chunk_dims=None, linked=False,
                linked_comp=False, sparse_origins=()):
        array = np.asarray(array)
        nt_ref, nt_code = self._nt(array.dtype)
        sdd_ref = self._ref()
        rank = array.ndim
        sdd = struct.pack('>H', rank)
        sdd += b''.join(struct.pack('>I', d) for d in array.shape)
        for _ in range(rank + 1):
            sdd += struct.pack('>HH', H.DFTAG_NT, nt_ref)
        self._add(H.DFTAG_SDD, sdd_ref, sdd)

        raw = array.astype(array.dtype.newbyteorder('>')).tobytes()
        sd_ref = self._ref()
        if chunked:
            self._write_chunked(sd_ref, array, nt_code, compress,
                                chunk_dims, sparse_origins)
        elif compress:
            comp_ref = self._ref()
            if linked_comp:
                # compressed stream itself laid out in linked blocks
                # (appendable-element layout)
                self._add_linked(H.DFTAG_COMPRESSED, comp_ref,
                                 zlib.compress(raw), blk_len=512)
            else:
                self._add(H.DFTAG_COMPRESSED, comp_ref,
                          zlib.compress(raw))
            header = struct.pack('>hHiHHH', H.SPECIAL_COMP, 0, len(raw),
                                 comp_ref, 0, H.COMP_CODE_DEFLATE)
            header += struct.pack('>H', 6)  # deflate level
            self._add(H.DFTAG_SD | H.EXT_TAG_BIT, sd_ref, header)
        elif linked:
            self._add_linked(H.DFTAG_SD, sd_ref, raw)
        else:
            self._add(H.DFTAG_SD, sd_ref, raw)

        ndg_ref = self._ref()
        ndg = struct.pack('>HHHH', H.DFTAG_SDD, sdd_ref, H.DFTAG_SD,
                          sd_ref)
        self._add(H.DFTAG_NDG, ndg_ref, ndg)

        members = [(H.DFTAG_SDD, sdd_ref), (H.DFTAG_SD, sd_ref),
                   (H.DFTAG_NT, nt_ref)]
        for aname, avalue in (attrs or {}).items():
            members.append((H.DFTAG_VH, self.attr_vdata(aname, avalue)))
        self._vgroup(name, 'Var0.0', members)

    def _write_chunked(self, sd_ref, array, nt_code, compress,
                       chunk_dims, sparse_origins=()):
        dims = list(array.shape)
        nt_size = self._nt_size(nt_code)
        if chunk_dims is None:
            chunk_dims = [min(d, 256) for d in dims]
        n_chunks = [int(np.ceil(d / c)) for d, c in zip(dims, chunk_dims)]
        be = array.astype(array.dtype.newbyteorder('>'))

        records = b''
        nvert = 0
        for origin in np.ndindex(*n_chunks):
            if tuple(origin) in set(map(tuple, sparse_origins)):
                # unwritten chunk: table record with null tag/ref
                records += b''.join(struct.pack('>i', o)
                                    for o in origin)
                records += struct.pack('>HH', 0, 0)
                nvert += 1
                continue
            sl = tuple(slice(o * c, (o + 1) * c)
                       for o, c in zip(origin, chunk_dims))
            chunk = np.zeros(chunk_dims, dtype=be.dtype)
            src = be[sl]
            chunk[tuple(slice(0, s) for s in src.shape)] = src
            raw = chunk.tobytes()
            chunk_ref = self._ref()
            if compress:
                comp_ref = self._ref()
                self._add(H.DFTAG_COMPRESSED, comp_ref,
                          zlib.compress(raw))
                header = struct.pack('>hHiHHH', H.SPECIAL_COMP, 0,
                                     len(raw), comp_ref, 0,
                                     H.COMP_CODE_DEFLATE)
                header += struct.pack('>H', 6)
                self._add(H.DFTAG_CHUNK | H.EXT_TAG_BIT, chunk_ref,
                          header)
            else:
                self._add(H.DFTAG_CHUNK, chunk_ref, raw)
            records += b''.join(struct.pack('>i', o) for o in origin)
            records += struct.pack('>HH', H.DFTAG_CHUNK, chunk_ref)
            nvert += 1

        ndims = len(dims)
        rec_size = 4 * ndims + 4
        tbl_ref = self._ref()
        head = struct.pack('>HIHH', 0, nvert, rec_size, 1)
        head += struct.pack('>H', 24)          # DFNT_INT32 proxy field
        head += struct.pack('>H', rec_size)
        head += struct.pack('>H', 0)
        head += struct.pack('>H', 1)
        fname = 'chunk_rec'
        head += struct.pack('>H', len(fname)) + fname.encode()
        name = '_HDF_CHK_TBL_0'
        head += struct.pack('>H', len(name)) + name.encode()
        klass = '_HDF_CHK_TBL_'
        head += struct.pack('>H', len(klass)) + klass.encode()
        head += struct.pack('>HHH', 0, 0, 3)
        self._add(H.DFTAG_VH, tbl_ref, head)
        self._add(H.DFTAG_VS, tbl_ref, records)

        total = int(np.prod(dims)) * nt_size
        chunk_bytes = int(np.prod(chunk_dims)) * nt_size
        header = struct.pack('>h', H.SPECIAL_CHUNKED)
        header += struct.pack('>iBiiii', 0, 1, 0, total, chunk_bytes,
                              nt_size)
        header += struct.pack('>HHHHi', H.DFTAG_VH, tbl_ref, 0, 0,
                              len(dims))
        for d, c in zip(dims, chunk_dims):
            header += struct.pack('>iii', 1, d, c)
        self._add(H.DFTAG_SD | H.EXT_TAG_BIT, sd_ref, header)

    def save(self, path, dd_block_size=None):
        # layout: magic | DD block chain | element data. The real HDF4
        # library grows the DD list in fixed-size blocks linked by the
        # next-offset field; dd_block_size emulates that chain.
        elems = self._elements
        n = len(elems)
        size = dd_block_size or max(n, 1)
        groups = [elems[i:i + size] for i in range(0, n, size)] or [[]]
        block_offsets = []
        off = 4
        for g in groups:
            block_offsets.append(off)
            off += 6 + 12 * len(g)
        data_offset = off
        dd_blocks = []
        for bi, g in enumerate(groups):
            nxt = block_offsets[bi + 1] if bi + 1 < len(groups) else 0
            dd = struct.pack('>HI', len(g), nxt)
            for tag, ref, data in g:
                dd += struct.pack('>HHII', tag, ref, data_offset,
                                  len(data))
                data_offset += len(data)
            dd_blocks.append(dd)
        with open(path, 'wb') as fh:
            fh.write(H.HDF4_MAGIC)
            for d in dd_blocks:
                fh.write(d)
            for _, _, data in elems:
                fh.write(data)
        return path


def make_struct_metadata(ulx, uly, lrx, lry, xdim, ydim, zone):
    return (
        'GROUP=SwathStructure\nEND_GROUP=SwathStructure\n'
        'GROUP=GridStructure\n\tGROUP=GRID_1\n'
        '\t\tGridName="Grid"\n'
        f'\t\tXDim={xdim}\n\t\tYDim={ydim}\n'
        f'\t\tUpperLeftPointMtrs=({ulx:.6f},{uly:.6f})\n'
        f'\t\tLowerRightMtrs=({lrx:.6f},{lry:.6f})\n'
        '\t\tProjection=GCTP_UTM\n'
        f'\t\tZoneCode={zone}\n'
        '\t\tSphereCode=12\n'
        '\tEND_GROUP=GRID_1\nEND_GROUP=GridStructure\nEND\n')
