"""HDF4-EOS reader for HLS v1 products (plus a writer for self-tests).

HLS v1 distributes all bands inside one HDF4-EOS file; the reference reads
them through GDAL's HDF4_EOS driver (dswx_hls.py:2358). This module
implements the HDF4 subset those products use, from the HDF 4.2
specification:

- the DD (data-descriptor) chain;
- Vgroups (DFTAG_VG) / Vdatas (DFTAG_VH/VS) — the SD API's annotation
  layer: each SDS is a Vgroup of class 'Var0.0' whose name is the dataset
  name, with 'Attr0.0' Vdatas carrying attributes; global attributes
  (including the HDF-EOS 'StructMetadata.0' grid text) are top-level
  'Attr0.0' Vdatas;
- scientific data sets: NDG + SDD dimension records + NT number types;
- special elements: SPECIAL_COMP (DEFLATE) and SPECIAL_CHUNKED with
  per-chunk DEFLATE, the layout the HLS v1 production used.

Caveat: this environment has no HDF4 tooling or sample HLS v1 granules,
so the format handling is validated against this module's own writer and
the published spec, not against real products yet.
"""

import struct
import zlib

import numpy as np

HDF4_MAGIC = b'\x0e\x03\x13\x01'

DFTAG_NT = 106
DFTAG_SD = 702
DFTAG_SDD = 701
DFTAG_NDG = 720
DFTAG_VH = 1962
DFTAG_VS = 1963
DFTAG_VG = 1965
DFTAG_COMPRESSED = 40
DFTAG_CHUNK = 61
DFTAG_LINKED = 20
DFTAG_VERSION = 30

EXT_TAG_BIT = 0x4000

SPECIAL_LINKED = 1
SPECIAL_EXT = 2
SPECIAL_COMP = 3
SPECIAL_VLINKED = 4
SPECIAL_CHUNKED = 5

COMP_CODE_NONE = 0
COMP_CODE_DEFLATE = 4

# HDF4 number types -> (numpy dtype, DFNT code)
_NT_DTYPES = {
    5: np.float32, 6: np.float64,
    20: np.int8, 21: np.uint8, 22: np.int16, 23: np.uint16,
    24: np.int32, 25: np.uint32, 3: np.uint8, 4: np.int8,
}
_DTYPE_NT = {np.dtype(np.float32): 5, np.dtype(np.float64): 6,
             np.dtype(np.int8): 20, np.dtype(np.uint8): 21,
             np.dtype(np.int16): 22, np.dtype(np.uint16): 23,
             np.dtype(np.int32): 24, np.dtype(np.uint32): 25}


def is_hdf4(path):
    try:
        with open(path, 'rb') as fh:
            return fh.read(4) == HDF4_MAGIC
    except (OSError, TypeError):
        return False


class Hdf4File:
    """Parsed HDF4 container: SDS datasets by name + attributes."""

    def __init__(self, path):
        self.path = path
        self._fh = open(path, 'rb')
        if self._fh.read(4) != HDF4_MAGIC:
            self._fh.close()
            raise ValueError(f'not an HDF4 file: {path}')
        self._dds = {}
        self._read_dd_chain()
        self._vdatas = None
        self._vgroups = None
        self._sds = None
        self._global_attrs = None

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- container ----------------------------------------------------------

    def _read_dd_chain(self):
        offset = 4
        while offset:
            self._fh.seek(offset)
            ndd, next_off = struct.unpack('>HI', self._fh.read(6))
            raw = self._fh.read(12 * ndd)
            for i in range(ndd):
                tag, ref, off, length = struct.unpack(
                    '>HHII', raw[12 * i:12 * (i + 1)])
                if tag not in (0, 1):  # skip DFTAG_NULL / utility
                    self._dds[(tag, ref)] = (off, length)
            offset = next_off

    def _read(self, tag, ref):
        loc = self._dds.get((tag, ref))
        if loc is None:
            raise KeyError(f'missing HDF4 element (tag={tag}, ref={ref})')
        self._fh.seek(loc[0])
        return self._fh.read(loc[1])

    # -- vdata / vgroup layer -------------------------------------------------

    def _parse_vdatas(self):
        if self._vdatas is not None:
            return self._vdatas
        out = {}
        for (tag, ref) in self._dds:
            if tag != DFTAG_VH:
                continue
            data = self._read(tag, ref)
            p = 0

            def u16():
                nonlocal p
                v = struct.unpack('>H', data[p:p + 2])[0]
                p += 2
                return v

            def u32():
                nonlocal p
                v = struct.unpack('>I', data[p:p + 4])[0]
                p += 4
                return v

            _interlace = u16()
            nvert = u32()
            ivsize = u16()
            nfields = u16()
            types = [u16() for _ in range(nfields)]
            isizes = [u16() for _ in range(nfields)]
            offsets = [u16() for _ in range(nfields)]
            orders = [u16() for _ in range(nfields)]
            fieldnames = []
            for _ in range(nfields):
                ln = u16()
                fieldnames.append(data[p:p + ln].decode('latin-1'))
                p += ln
            ln = u16()
            name = data[p:p + ln].decode('latin-1').rstrip('\0 ')
            p += ln
            ln = u16()
            klass = data[p:p + ln].decode('latin-1').rstrip('\0 ')
            out[ref] = {
                'name': name, 'class': klass, 'nvert': nvert,
                'ivsize': ivsize, 'types': types, 'orders': orders,
                'isizes': isizes, 'offsets': offsets,
                'fields': fieldnames,
            }
        self._vdatas = out
        return out

    def _vdata_values(self, ref):
        """Decode a single-field vdata into a numpy array or string."""
        vh = self._parse_vdatas()[ref]
        raw = self._read_data_element(DFTAG_VS, ref,
                                      vh['nvert'] * vh['ivsize'])
        nt = vh['types'][0]
        dtype = np.dtype(_NT_DTYPES[nt]).newbyteorder('>')
        count = vh['nvert'] * vh['orders'][0]
        if nt in (3, 4):  # UCHAR8 / CHAR8 -> string
            return raw[:count].decode('latin-1').rstrip('\0')
        return np.frombuffer(raw, dtype=dtype, count=count).astype(
            dtype.newbyteorder('='))

    def _parse_vgroups(self):
        if self._vgroups is not None:
            return self._vgroups
        out = {}
        for (tag, ref) in self._dds:
            if tag != DFTAG_VG:
                continue
            data = self._read(tag, ref)
            p = 0
            nelt = struct.unpack('>H', data[p:p + 2])[0]
            p += 2
            tags = struct.unpack('>' + 'H' * nelt,
                                 data[p:p + 2 * nelt])
            p += 2 * nelt
            refs = struct.unpack('>' + 'H' * nelt,
                                 data[p:p + 2 * nelt])
            p += 2 * nelt
            ln = struct.unpack('>H', data[p:p + 2])[0]
            p += 2
            name = data[p:p + ln].decode('latin-1').rstrip('\0 ')
            p += ln
            ln = struct.unpack('>H', data[p:p + 2])[0]
            p += 2
            klass = data[p:p + ln].decode('latin-1').rstrip('\0 ')
            out[ref] = {'name': name, 'class': klass,
                        'members': list(zip(tags, refs))}
        self._vgroups = out
        return out

    # -- SDS access -----------------------------------------------------------

    def _parse_sdd(self, sdd_ref):
        data = self._read(DFTAG_SDD, sdd_ref)
        rank = struct.unpack('>H', data[:2])[0]
        dims = struct.unpack('>' + 'I' * rank, data[2:2 + 4 * rank])
        # NT references: one for the data, then one per dimension scale
        nt_tag, nt_ref = struct.unpack('>HH',
                                       data[2 + 4 * rank:6 + 4 * rank])
        nt = self._read(DFTAG_NT, nt_ref)
        type_code = nt[1]
        if type_code not in _NT_DTYPES:
            raise ValueError(f'unsupported HDF4 number type {type_code}')
        return dims, np.dtype(_NT_DTYPES[type_code])

    def datasets(self):
        """{name: (sd_ref, shape, dtype, attrs)} for every SDS."""
        if self._sds is not None:
            return self._sds
        vgroups = self._parse_vgroups()
        vdatas = self._parse_vdatas()
        out = {}
        for ref, vg in vgroups.items():
            if vg['class'] != 'Var0.0':
                continue
            sd_ref = sdd_ref = None
            attrs = {}
            for mtag, mref in vg['members']:
                if mtag == DFTAG_SD or mtag == (DFTAG_SD | EXT_TAG_BIT):
                    sd_ref = mref
                elif mtag == DFTAG_SDD:
                    sdd_ref = mref
                elif mtag == DFTAG_VH and mref in vdatas \
                        and vdatas[mref]['class'] == 'Attr0.0':
                    attrs[vdatas[mref]['name']] = self._vdata_values(mref)
            if sd_ref is None or sdd_ref is None:
                continue
            shape, dtype = self._parse_sdd(sdd_ref)
            out[vg['name']] = (sd_ref, shape, dtype, attrs)
        self._sds = out
        return out

    def global_attributes(self):
        """Top-level 'Attr0.0' vdatas not owned by any Var vgroup."""
        if self._global_attrs is not None:
            return self._global_attrs
        vdatas = self._parse_vdatas()
        owned = set()
        for vg in self._parse_vgroups().values():
            for mtag, mref in vg['members']:
                if mtag == DFTAG_VH:
                    owned.add(mref)
        out = {}
        for ref, vh in vdatas.items():
            if vh['class'] == 'Attr0.0' and ref not in owned:
                out[vh['name']] = self._vdata_values(ref)
        self._global_attrs = out
        return out

    # -- data element decode ---------------------------------------------------

    def _read_data_element(self, tag, ref, expected_size):
        """Read a (possibly special) data element's bytes.

        ``expected_size`` may be None for elements whose stored length
        is not knowable up front (e.g. a compressed byte stream laid
        out in linked blocks)."""
        if (tag | EXT_TAG_BIT, ref) in self._dds:
            data = self._read(tag | EXT_TAG_BIT, ref)
            return self._decode_special(data, expected_size)
        return self._read(tag, ref)

    def _decode_special(self, header, expected_size):
        sp = struct.unpack('>h', header[:2])[0]
        if sp == SPECIAL_COMP:
            # [i16 sp][u16 version][i32 uncomp_len][u16 comp_ref]
            # [u16 model_type][u16 comp_type][coder info]
            _ver, _ulen, comp_ref, _model, comp_type = struct.unpack(
                '>HiHHH', header[2:14])
            # the compressed stream itself may be a special element
            # (linked blocks, when the writer appended incrementally)
            payload = self._read_data_element(DFTAG_COMPRESSED,
                                              comp_ref, None)
            if comp_type == COMP_CODE_DEFLATE:
                return zlib.decompress(payload)
            if comp_type == COMP_CODE_NONE:
                return payload
            raise ValueError(
                f'unsupported HDF4 compression code {comp_type}')
        if sp == SPECIAL_CHUNKED:
            return self._decode_chunked(header, expected_size)
        if sp == SPECIAL_LINKED:
            # [i16 sp][i32 length][i32 blk_len][i32 num_blk][u16 link_ref]
            length, _blk_len, _nblk, link_ref = struct.unpack(
                '>iiiH', header[2:16])
            if expected_size is None:
                expected_size = length if length > 0 else None
            return self._read_linked(link_ref, expected_size)
        raise ValueError(f'unsupported HDF4 special element {sp}')

    def _read_linked(self, link_ref, expected_size):
        """Linked-block element (HDF 4.2 spec 'Linked Block Elements',
        hblocks layout): ``link_ref`` names a block TABLE —
        [u16 next_table_ref][u16 block_ref x n] — whose entries name
        the data blocks; all carry tag DFTAG_LINKED. Zero refs mark
        unused table slots."""
        out = bytearray()
        tbl_ref = link_ref
        seen = set()
        while tbl_ref:
            if tbl_ref in seen:
                raise ValueError(
                    f'cyclic HDF4 linked-block table chain at ref '
                    f'{tbl_ref}')
            seen.add(tbl_ref)
            tbl = self._read(DFTAG_LINKED, tbl_ref)
            next_ref = struct.unpack('>H', tbl[:2])[0]
            n = (len(tbl) - 2) // 2
            refs = struct.unpack('>' + 'H' * n, tbl[2:2 + 2 * n])
            for r in refs:
                if r == 0:
                    continue
                out += self._read(DFTAG_LINKED, r)
                if expected_size is not None and \
                        len(out) >= expected_size:
                    return bytes(out[:expected_size])
            tbl_ref = next_ref
        if expected_size is not None:
            return bytes(out[:expected_size])
        return bytes(out)

    def _decode_chunked(self, header, expected_size):
        # [i16 sp][i32 head_len][u8 version][i32 flag][i32 elem_tot]
        # [i32 chunk_size][i32 nt_size][u16 tbl_tag][u16 tbl_ref]
        # [u16 sp_tag][u16 sp_ref][i32 ndims]{i32 flag,i32 dim,i32 chunk}*
        p = 2
        _head_len, _version, _flag, _tot, _chunk_size, nt_size = \
            struct.unpack('>iBiiii', header[p:p + 21])
        p += 21
        tbl_tag, tbl_ref, _sp_tag, _sp_ref, ndims = struct.unpack(
            '>HHHHi', header[p:p + 12])
        p += 12
        dims = []
        chunk_dims = []
        for _ in range(ndims):
            _dflag, dim_len, chunk_len = struct.unpack(
                '>iii', header[p:p + 12])
            p += 12
            dims.append(dim_len)
            chunk_dims.append(chunk_len)

        # chunk table vdata: fields origin[ndims] (int32), chk_tag, chk_ref
        vh = self._parse_vdatas()[tbl_ref]
        raw = self._read_data_element(DFTAG_VS, tbl_ref,
                                      vh['nvert'] * vh['ivsize'])
        rec_size = vh['ivsize']
        # assemble the padded chunk grid in raw bytes (last axis in bytes)
        n_chunks = [int(np.ceil(d / c)) for d, c in zip(dims, chunk_dims)]
        chunk_bytes = int(np.prod(chunk_dims)) * nt_size
        grid_shape = [nc * cd for nc, cd in zip(n_chunks, chunk_dims)]
        grid_shape[-1] *= nt_size
        full = np.zeros(grid_shape, dtype=np.uint8)
        for rec in range(vh['nvert']):
            rec_raw = raw[rec * rec_size:(rec + 1) * rec_size]
            origin = struct.unpack('>' + 'i' * ndims,
                                   rec_raw[:4 * ndims])
            chk_tag, chk_ref = struct.unpack(
                '>HH', rec_raw[4 * ndims:4 * ndims + 4])
            if chk_tag in (0, 0xFFFF) or chk_ref in (0, 0xFFFF):
                # unwritten (sparse) chunk: stays zero-filled
                continue
            blob = self._read_data_element(chk_tag, chk_ref, chunk_bytes)
            chunk = np.frombuffer(blob[:chunk_bytes], dtype=np.uint8)
            chunk = chunk.reshape([*chunk_dims[:-1],
                                   chunk_dims[-1] * nt_size])
            slices = tuple(
                slice(o * c, (o + 1) * c) for o, c in
                zip(origin[:-1], chunk_dims[:-1])) + (
                slice(origin[-1] * chunk_dims[-1] * nt_size,
                      (origin[-1] + 1) * chunk_dims[-1] * nt_size),)
            full[slices] = chunk
        crop = tuple(slice(0, d) for d in dims[:-1]) + (
            slice(0, dims[-1] * nt_size),)
        return full[crop].tobytes()

    def read_sds(self, name, window=None):
        """Read an SDS by name; window=(row0, col0, h, w) for 2-D data."""
        sd_ref, shape, dtype, _attrs = self.datasets()[name]
        expected = int(np.prod(shape)) * dtype.itemsize
        raw = self._read_data_element(DFTAG_SD, sd_ref, expected)
        arr = np.frombuffer(raw[:expected],
                            dtype=dtype.newbyteorder('>'))
        arr = arr.reshape(shape).astype(dtype)
        if window is not None and arr.ndim == 2:
            r0, c0, h, w = window
            arr = arr[r0:r0 + h, c0:c0 + w]
        return arr


def parse_struct_metadata(text):
    """Parse the HDF-EOS StructMetadata.0 grid block: returns
    (geotransform, utm_zone, (ydim, xdim)) or None."""
    import re
    ul = re.search(r'UpperLeftPointMtrs=\(([-\d.]+),([-\d.]+)\)', text)
    lr = re.search(r'LowerRightMtrs=\(([-\d.]+),([-\d.]+)\)', text)
    xd = re.search(r'XDim=(\d+)', text)
    yd = re.search(r'YDim=(\d+)', text)
    zone = re.search(r'ZoneCode=(-?\d+)', text)
    if not (ul and lr and xd and yd):
        return None
    ulx, uly = float(ul.group(1)), float(ul.group(2))
    lrx, lry = float(lr.group(1)), float(lr.group(2))
    w, h = int(xd.group(1)), int(yd.group(1))
    gt = (ulx, (lrx - ulx) / w, 0.0, uly, 0.0, (lry - uly) / h)
    return gt, (int(zone.group(1)) if zone else None), (h, w)


class Hdf4Raster:
    """Raster adapter for one band of an HLS v1 HDF4-EOS product,
    matching the interface proteus_jax.io.hls expects."""

    def __init__(self, path, band_name):
        self.f = Hdf4File(path)
        datasets = self.f.datasets()
        if band_name not in datasets:
            self.f.close()
            raise ValueError(
                f'band {band_name!r} not found in {path}; available:'
                f' {sorted(datasets)}')
        self.band_name = band_name
        _, self.shape, self.dtype, self.attrs = datasets[band_name]
        self._meta = {k: (v if isinstance(v, str) else
                          (float(v[0]) if np.ndim(v) and len(v) == 1
                           else v))
                      for k, v in self.f.global_attributes().items()}
        self._struct = None
        sm = self._meta.get('StructMetadata.0')
        if isinstance(sm, str):
            self._struct = parse_struct_metadata(sm)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()

    def read(self, window=None):
        return self.f.read_sds(self.band_name, window=window)

    def nodata(self):
        fv = self.attrs.get('_FillValue')
        if fv is None:
            return None
        return float(fv[0]) if np.ndim(fv) else float(fv)

    def metadata(self):
        md = {}
        for k, v in self._meta.items():
            if k == 'StructMetadata.0':
                continue
            md[k] = v if isinstance(v, str) else str(
                v[0] if np.ndim(v) and len(v) == 1 else v)
        for k, v in self.attrs.items():
            if k == '_FillValue':
                md.setdefault('_FillValue', str(
                    v[0] if np.ndim(v) else v))
            elif k in ('scale_factor', 'add_offset'):
                md[k] = str(float(v[0] if np.ndim(v) else v))
        return md

    def geotransform(self):
        if self._struct:
            return self._struct[0]
        return (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

    def projection(self):
        if self._struct and self._struct[1]:
            from proteus_jax.geo.crs import CRS
            zone = self._struct[1]
            return CRS.from_utm(abs(zone), zone > 0).to_wkt()
        return ''
