"""Functional GDAL/OSR/OGR shim backed by proteus_jax's own engines.

refbridge loads the reference's dswx_hls module with *inert* GDAL stubs —
enough to call its pure-NumPy science functions. This module goes
further: it provides a *working* subset of the ``osgeo.gdal`` /
``osgeo.osr`` / ``osgeo.ogr`` API surface that the reference orchestrator
(``generate_dswx_layers``) actually touches, implemented on top of this
repo's own I/O and geo engines:

    gdal.Open / ReadAsArray / metadata      -> proteus_jax.io.tiff
    driver('GTiff').Create + WriteArray     -> proteus_jax.io.cog.write_cog
    gdal.Warp (bounds/res/SRS/resampleAlg)  -> proteus_jax.geo.warp
    gdal.Translate(format='PNG')            -> proteus_jax.io.png
    osr.SpatialReference / Transformation   -> proteus_jax.geo.crs
    ogr.Geometry (ring/polygon containers)  -> lightweight shim

With these injected (see tests/test_reference_e2e.py), the REFERENCE'S
OWN orchestrator runs end-to-end — ingest, ancillary warping, science,
product writing, browse generation — against this repo's engines, and
its products can be compared bit-for-bit with this repo's orchestrator
output on the same scene. That executes every reference code path the
offline environment allows (the real-GDAL-internals behavior is the one
thing it cannot cover).

No reference code is copied; the reference module is imported in place
and only called.
"""

import os
import re

import numpy as np

from proteus_jax.geo.crs import CRS, transform_points
from proteus_jax.geo import warp as _warp_engine
from proteus_jax.io import png as _png
from proteus_jax.io.cog import write_cog
from proteus_jax.io.tiff import TiffReader

# ---------------------------------------------------------------------------
# gdal constants
# ---------------------------------------------------------------------------

GA_ReadOnly = 0
GA_Update = 1

_GDT_NAMES = {1: 'Byte', 2: 'UInt16', 3: 'Int16', 4: 'UInt32', 5: 'Int32',
              6: 'Float32', 7: 'Float64'}
_GDT_TO_NP = {1: np.uint8, 2: np.uint16, 3: np.int16, 4: np.uint32,
              5: np.int32, 6: np.float32, 7: np.float64}
_NP_TO_GDT = {np.dtype(v): k for k, v in _GDT_TO_NP.items()}

GDT_Byte = 1
GDT_UInt16 = 2
GDT_Int16 = 3
GDT_UInt32 = 4
GDT_Int32 = 5
GDT_Float32 = 6
GDT_Float64 = 7

GCI_PaletteIndex = 2
GMF_ALL_VALID = 1
GMF_PER_DATASET = 2


def TermProgress_nocb(*args, **kwargs):
    return 1


def VersionInfo(key=None):
    return '3060200'  # behave like the reference docker's GDAL 3.6.2


def PushErrorHandler(*args):
    return None


def PopErrorHandler():
    return None


def GetLastErrorMsg():
    return ''


def VSIFOpenL(path, mode):
    try:
        return open(path, mode if 'b' in mode else mode + 'b')
    except OSError:
        return None


def VSIFReadL(size, count, fh):
    return fh.read(size * count)


def VSIFSeekL(fh, offset, whence):
    return fh.seek(offset, whence)


def VSIFCloseL(fh):
    fh.close()
    return 0


def VSIStatL(path):
    try:
        st = os.stat(path)
    except OSError:
        return None

    class _Stat:
        size = st.st_size
    return _Stat()


def GetDataTypeName(code):
    return _GDT_NAMES[code]


def SetConfigOption(key, value):
    return None


# ---------------------------------------------------------------------------
# Color table
# ---------------------------------------------------------------------------

# GDAL persists color-table alpha through PAM (.aux.xml) sidecars; TIFF
# colormaps cannot carry it. This registry plays the PAM role so the
# browse GeoTIFF -> PNG path keeps its transparent entries.
_PAM_CTABLES = {}


class ColorTable:
    def __init__(self):
        self._entries = {}

    def SetColorEntry(self, index, rgba):
        self._entries[int(index)] = tuple(rgba)

    def GetColorEntry(self, index):
        return self._entries.get(int(index), (0, 0, 0, 255))

    def GetCount(self):
        return (max(self._entries) + 1) if self._entries else 0

    def to_color_map(self):
        return {i: v[:3] for i, v in self._entries.items()}


# ---------------------------------------------------------------------------
# Read-side dataset (wraps TiffReader)
# ---------------------------------------------------------------------------

class _ReadBand:
    def __init__(self, ds, index, ifd_index=0):
        self._ds = ds
        self._index = index
        self._ifd_index = ifd_index

    @property
    def _ifd(self):
        return self._ds._reader.ifds[self._ifd_index]

    @property
    def XSize(self):
        return self._ifd.width

    @property
    def YSize(self):
        return self._ifd.length

    @property
    def DataType(self):
        return _NP_TO_GDT[np.dtype(self._ds._reader.dtype)]

    # --- structural queries the reference COG validator relies on -----

    def GetBlockSize(self):
        ifd = self._ifd
        if ifd.is_tiled:
            return [int(ifd.scalar(322)), int(ifd.scalar(323))]
        return [ifd.width, int(ifd.scalar(278, ifd.length))]

    def GetOverviewCount(self):
        return len(self._ds._reader.ifds) - 1

    def GetOverview(self, i):
        return _ReadBand(self._ds, self._index, ifd_index=i + 1)

    def GetMetadataItem(self, key, domain=''):
        if domain != 'TIFF':
            return None
        ifd = self._ifd
        if key == 'IFD_OFFSET':
            return str(ifd.file_offset)
        m = re.match(r'^BLOCK_(OFFSET|SIZE)_(\d+)_(\d+)$', key)
        if not m:
            return None
        kind, x, y = m.group(1), int(m.group(2)), int(m.group(3))
        if ifd.is_tiled:
            tw, tl = int(ifd.scalar(322)), int(ifd.scalar(323))
            tiles_across = (ifd.width + tw - 1) // tw
            values = ifd.get(324 if kind == 'OFFSET' else 325)
            idx = y * tiles_across + x
        else:
            values = ifd.get(273 if kind == 'OFFSET' else 279)
            idx = y
        if values is None or idx >= len(values):
            return None
        return str(int(values[idx]))

    def GetMaskFlags(self):
        return 1  # GMF_ALL_VALID: no mask bands in this writer

    def GetMaskBand(self):
        return None

    def GetNoDataValue(self):
        return self._ds._nodata

    def ReadAsArray(self, xoff=0, yoff=0, win_xsize=None, win_ysize=None):
        return self._ds._read_window(xoff, yoff, win_xsize, win_ysize,
                                     band=self._index - 1)

    def GetDescription(self):
        descs = self._ds._reader.band_descriptions() or {}
        return descs.get(self._index - 1) or ''

    def GetMetadata(self):
        return dict(self._ds.GetMetadata())

    def GetRasterColorTable(self):
        cmap = self._ds._reader.color_map()
        if not cmap:
            return None
        ct = ColorTable()
        for value, rgb in cmap.items():
            ct.SetColorEntry(value, tuple(rgb) + (255,))
        return ct


class _ReadDataset:
    def __init__(self, path):
        self._path = path
        self._reader = TiffReader(path)
        self._nodata = self._reader.nodata()

    @property
    def RasterXSize(self):
        return self._reader.width

    @property
    def RasterYSize(self):
        return self._reader.length

    @property
    def RasterCount(self):
        return self._reader.count

    def GetRasterBand(self, index):
        return _ReadBand(self, index)

    def GetMetadata(self):
        return dict(self._reader.metadata() or {})

    def GetGeoTransform(self):
        gt = self._reader.geotransform()
        return tuple(gt) if gt is not None else (0., 1., 0., 0., 0., 1.)

    def GetProjection(self):
        epsg = self._reader.epsg()
        return CRS.from_epsg(epsg).to_wkt() if epsg else ''

    GetProjectionRef = GetProjection

    def GetDescription(self):
        return self._path

    def GetDriver(self):
        class _D:
            ShortName = 'GTiff'
        return _D()

    def GetFileList(self):
        return [self._path]

    def _read_window(self, xoff, yoff, win_xsize, win_ysize, band=None):
        if win_xsize is None and win_ysize is None and xoff == 0 \
                and yoff == 0:
            window = None
        else:
            win_xsize = win_xsize if win_xsize is not None \
                else self._reader.width - xoff
            win_ysize = win_ysize if win_ysize is not None \
                else self._reader.length - yoff
            window = (yoff, xoff, win_ysize, win_xsize)
        if band is not None:
            return self._reader.read(window=window, band=band)
        if self._reader.count == 1:
            return self._reader.read(window=window, band=0)
        planes = [self._reader.read(window=window, band=b)
                  for b in range(self._reader.count)]
        return np.stack(planes, axis=0)

    def ReadAsArray(self, xoff=0, yoff=0, xsize=None, ysize=None):
        return self._read_window(xoff, yoff, xsize, ysize)

    def FlushCache(self):
        return None


# ---------------------------------------------------------------------------
# Write-side dataset (persists through proteus_jax's COG writer)
# ---------------------------------------------------------------------------

class _WriteBand:
    def __init__(self, ds, index):
        self._ds = ds
        self._index = index

    @property
    def XSize(self):
        return self._ds.RasterXSize

    @property
    def YSize(self):
        return self._ds.RasterYSize

    def SetNoDataValue(self, value):
        self._ds._nodata = value

    def GetNoDataValue(self):
        return self._ds._nodata

    def WriteArray(self, array):
        if array is None:
            # mirror osgeo: BandWriteArray touches array.shape
            raise AttributeError(
                "'NoneType' object has no attribute 'shape'")
        self._ds._arrays[self._index - 1] = np.asarray(array)

    def SetRasterColorTable(self, ct):
        self._ds._ctable = ct

    def SetRasterColorInterpretation(self, interp):
        return None

    def SetDescription(self, description):
        self._ds._descriptions[self._index - 1] = description

    def SetMetadata(self, metadata):
        self._ds._band_metadata[self._index - 1] = dict(metadata)

    def FlushCache(self):
        return None


class _WriteDataset:
    def __init__(self, path, xsize, ysize, nbands, gdt):
        self._path = path
        self.RasterXSize = xsize
        self.RasterYSize = ysize
        self.RasterCount = nbands
        self._dtype = _GDT_TO_NP[gdt]
        self._arrays = [None] * nbands
        self._descriptions = [None] * nbands
        self._band_metadata = {}
        self._metadata = {}
        self._geotransform = (0., 1., 0., 0., 0., 1.)
        self._projection = ''
        self._nodata = None
        self._ctable = None
        self._flushed = False

    def SetMetadata(self, metadata):
        self._metadata = dict(metadata)

    def GetMetadata(self):
        return dict(self._metadata)

    def SetGeoTransform(self, gt):
        self._geotransform = tuple(float(v) for v in gt)

    def GetGeoTransform(self):
        return self._geotransform

    def SetProjection(self, projection):
        self._projection = projection

    def GetProjection(self):
        return self._projection

    def GetRasterBand(self, index):
        return _WriteBand(self, index)

    def _convert(self, array):
        """GDAL band-write conversion (GDALCopyWords): clamp to the band
        dtype's range; floats round half away from zero first."""
        if array.dtype == self._dtype:
            return array
        target = np.dtype(self._dtype)
        if target.kind in 'ui':
            info = np.iinfo(target)
            vals = array.astype(np.float64)
            if array.dtype.kind == 'f':
                vals = np.where(vals >= 0, np.floor(vals + 0.5),
                                np.ceil(vals - 0.5))
                vals = np.nan_to_num(vals, nan=0.0)
            return np.clip(vals, info.min, info.max).astype(target)
        return array.astype(target)

    def ReadAsArray(self, xoff=0, yoff=0, xsize=None, ysize=None):
        filled = [(self._convert(a) if a is not None
                   else np.zeros((self.RasterYSize, self.RasterXSize),
                                 self._dtype))
                  for a in self._arrays]
        stack = filled[0] if len(filled) == 1 else np.stack(filled, axis=0)
        if xsize is None and ysize is None and xoff == 0 and yoff == 0:
            return stack
        ysize = ysize if ysize is not None else self.RasterYSize - yoff
        xsize = xsize if xsize is not None else self.RasterXSize - xoff
        return stack[..., yoff:yoff + ysize, xoff:xoff + xsize]

    def FlushCache(self):
        if self._flushed or not self._path:  # MEM datasets never persist
            return None
        filled = [(self._convert(a) if a is not None
                   else np.zeros((self.RasterYSize, self.RasterXSize),
                                 self._dtype))
                  for a in self._arrays]
        stack = filled[0] if len(filled) == 1 \
            else np.stack(filled, axis=-1)
        epsg = CRS.from_any(self._projection).epsg if self._projection \
            else None
        color_map = self._ctable.to_color_map() if self._ctable else None
        descriptions = {i: d for i, d in enumerate(self._descriptions)
                        if d} or None
        metadata = {str(k): str(v) for k, v in self._metadata.items()} \
            or None
        write_cog(self._path, stack, geotransform=self._geotransform,
                  epsg=epsg, nodata=self._nodata,
                  metadata=metadata,
                  band_descriptions=descriptions,
                  color_map=color_map)
        if self._ctable is not None:
            _PAM_CTABLES[os.path.abspath(self._path)] = dict(
                self._ctable._entries)
        self._flushed = True
        return None

    def __del__(self):
        try:
            self.FlushCache()
        except Exception:
            pass


class _Driver:
    def __init__(self, name):
        self._name = name

    def Create(self, path, xsize, ysize, nbands=1, gdt=GDT_Byte):
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return _WriteDataset(path, xsize, ysize, nbands, gdt)


def GetDriverByName(name):
    return _Driver(name)


_HDF4_SUBDATASET = re.compile(r'^HDF4_EOS:EOS_GRID:"(.+)":Grid:(.+)$')


class _Hdf4Band:
    def __init__(self, ds):
        self._ds = ds

    @property
    def XSize(self):
        return self._ds.RasterXSize

    @property
    def YSize(self):
        return self._ds.RasterYSize

    def GetNoDataValue(self):
        return self._ds._raster.nodata()

    def ReadAsArray(self, xoff=0, yoff=0, win_xsize=None, win_ysize=None):
        return self._ds.ReadAsArray(xoff, yoff, win_xsize, win_ysize)


class _Hdf4ReadDataset:
    """HDF4-EOS subdataset facade (the reference's HLS v1 ingest opens
    'HDF4_EOS:EOS_GRID:"file":Grid:band' refs, dswx_hls.py:2358)."""

    def __init__(self, path, band_name):
        from proteus_jax.io.hdf4 import Hdf4Raster
        self._raster = Hdf4Raster(path, band_name)
        self.RasterYSize, self.RasterXSize = self._raster.shape
        self.RasterCount = 1

    def GetRasterBand(self, index):
        return _Hdf4Band(self)

    def GetMetadata(self):
        return dict(self._raster.metadata())

    def GetGeoTransform(self):
        return tuple(self._raster.geotransform())

    def GetProjection(self):
        return self._raster.projection()

    def ReadAsArray(self, xoff=0, yoff=0, xsize=None, ysize=None):
        if xsize is None and ysize is None and xoff == 0 and yoff == 0:
            return self._raster.read()
        h, w = self._raster.shape
        ysize = ysize if ysize is not None else h - yoff
        xsize = xsize if xsize is not None else w - xoff
        return self._raster.read(window=(yoff, xoff, ysize, xsize))

    def FlushCache(self):
        return None


def Open(path, mode=GA_ReadOnly):
    m = _HDF4_SUBDATASET.match(path)
    if m:
        try:
            return _Hdf4ReadDataset(m.group(1), m.group(2))
        except (OSError, ValueError):
            return None
    try:
        return _ReadDataset(path)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# gdal.Warp / gdal.Translate
# ---------------------------------------------------------------------------

def Warp(destination, source, format=None, dstSRS=None, outputBounds=None,
         multithread=False, xRes=None, yRes=None, resampleAlg='nearest',
         errorThreshold=None, **kwargs):
    """Subset of gdal.Warp the reference's _warp path uses
    (dswx_hls.py:3300-3310): reproject source onto the bounds/resolution
    grid. errorThreshold=0 maps to the exact per-pixel transformer."""
    min_x, min_y, max_x, max_y = outputBounds
    width = int(round((max_x - min_x) / xRes))
    length = int(round((max_y - min_y) / abs(yRes)))
    geotransform = (min_x, xRes, 0.0, max_y, 0.0, -abs(yRes))
    array = _warp_engine.warp_to_grid(
        source, geotransform, dstSRS, length, width,
        resample_algorithm=_RESAMPLE_ALG.get(str(resampleAlg).lower(),
                                             str(resampleAlg).lower()),
        margin_in_pixels=0)
    src_reader = TiffReader(source)
    nodata = src_reader.nodata()
    src_reader.close()
    ds = _WriteDataset(destination, width, length, 1,
                       _NP_TO_GDT[np.dtype(array.dtype)])
    ds._arrays[0] = array
    ds._geotransform = geotransform
    ds._projection = CRS.from_any(dstSRS).to_wkt()
    ds._nodata = nodata
    ds.FlushCache()
    return ds


_RESAMPLE_ALG = {'near': 'nearest', 'nearest': 'nearest',
                 'bilinear': 'bilinear', 'cubic': 'cubic',
                 'cubicspline': 'cubicspline'}


def Translate(destination, source, format=None, height=None, width=None,
              resampleAlg=None, nogcp=False, creationOptions=None,
              **kwargs):
    if format == 'PNG':
        rgba = _PAM_CTABLES.get(os.path.abspath(source))
        _png.geotiff2png(source, destination, output_height=height,
                         output_width=width, rgba_ctable=rgba)
        return True
    raise NotImplementedError(
        f'gdal_shim.Translate supports only PNG output (got {format!r}); '
        'COG rewriting goes through the bridged save_as_cog')


def DEMProcessing(destination, source, processing, azimuth=None,
                  altitude=None, **kwargs):
    """gdaldem hillshade (the reference's 'otsu' shadow branch,
    dswx_hls.py:4177-4212) backed by this repo's Horn-kernel
    implementation; pixel spacings come from the source geotransform."""
    if processing != 'hillshade':
        raise NotImplementedError(
            f'gdal_shim DEMProcessing supports only hillshade '
            f'(got {processing!r})')
    from proteus_jax.models.dswx.shadow import compute_hillshade_exact
    with TiffReader(source) as r:
        dem = r.read()
        gt = r.geotransform()
        epsg = r.epsg()
    hs = compute_hillshade_exact(np.asarray(dem, np.float32), azimuth,
                                 altitude, pixel_spacing_x=gt[1],
                                 pixel_spacing_y=gt[5])
    ds = _WriteDataset(destination, hs.shape[1], hs.shape[0], 1,
                       GDT_Byte)
    ds._arrays[0] = hs
    ds._geotransform = tuple(gt)
    if epsg:
        ds._projection = CRS.from_epsg(epsg).to_wkt()
    ds.FlushCache()
    return ds


def BuildVRT(*args, **kwargs):
    raise NotImplementedError('gdal_shim does not implement BuildVRT')


def BuildVRTOptions(*args, **kwargs):
    raise NotImplementedError('gdal_shim does not implement BuildVRT')


def RasterizeLayer(dataset, bands, layer, burn_values=(1,)):
    """Rasterize the layer's polygons into the dataset band; a pending
    Buffer margin is applied as the exact Euclidean distance-transform
    threshold (the production ocean-mask semantics, geo/polygon.py)."""
    from scipy.ndimage import distance_transform_edt
    from proteus_jax.geo.polygon import rasterize_rings
    gt = dataset.GetGeoTransform()
    h, w = dataset.RasterYSize, dataset.RasterXSize
    band = dataset.GetRasterBand(bands[0])
    existing = dataset._arrays[bands[0] - 1]
    if existing is None:
        existing = np.zeros((h, w), dataset._dtype)
    for feature in layer:
        geom = feature.GetGeometryRef()
        mask = np.zeros((h, w), np.uint8)
        rasterize_rings(geom.ring_arrays(), gt, h, w, out=mask)
        if geom._buffer_m > 0 and mask.any():
            dist = distance_transform_edt(
                mask == 0, sampling=(abs(gt[5]), abs(gt[1])))
            mask = (dist <= geom._buffer_m).astype(np.uint8)
        existing = np.where(mask, np.asarray(burn_values[0],
                                             dataset._dtype), existing)
    band.WriteArray(existing)
    return 0


# ---------------------------------------------------------------------------
# osr
# ---------------------------------------------------------------------------

OAMS_TRADITIONAL_GIS_ORDER = 0


class SpatialReference:
    """CRS facade with GDAL-3 axis-order semantics: proj4-defined CRS
    use traditional (lon, lat) order; EPSG/WellKnown-defined geographic
    CRS use authority (lat, lon) order unless SetAxisMappingStrategy
    switches them (the reference relies on both behaviors —
    dswx_hls.py:3420-3428 forces traditional; core.py:104-113 does not
    and unpacks lat-first)."""

    def __init__(self):
        self.crs = None
        self._traditional = True

    def ImportFromProj4(self, text):
        # the reference round-trips WKT through this call
        # (get_projection_proj4, dswx_hls.py:3130-3145); accept anything
        self.crs = CRS.from_any(text)
        self._traditional = True
        return 0

    ImportFromWkt = ImportFromProj4

    def ImportFromEPSG(self, code):
        self.crs = CRS.from_epsg(code)
        self._traditional = False
        return 0

    def SetUTM(self, zone, is_northern):
        self.crs = CRS.from_utm(zone, bool(is_northern))
        self._traditional = False
        return 0

    def SetWellKnownGeogCS(self, name):
        if str(name).upper() not in ('WGS84', 'WGS 84', 'EPSG:4326'):
            raise ValueError(f'unsupported GeogCS: {name}')
        self.crs = CRS.from_epsg(4326)
        self._traditional = False
        return 0

    def ExportToProj4(self):
        return self.crs.to_proj4()

    def ExportToWkt(self):
        return self.crs.to_wkt()

    def IsGeographic(self):
        return int(self.crs.is_geographic)

    def SetAxisMappingStrategy(self, strategy):
        self._traditional = True
        return None

    def IsSame(self, other):
        return int(self.crs.epsg == other.crs.epsg)

    def GetAuthorityCode(self, key):
        return str(self.crs.epsg)


class CoordinateTransformation:
    def __init__(self, src, dst):
        self._src = src.crs
        self._dst = dst.crs
        self._dst_swap = (dst.crs.is_geographic
                          and not dst._traditional)
        self._src_swap = (src.crs.is_geographic
                          and not src._traditional)

    def TransformPoint(self, x, y, z=0.0):
        if self._src_swap:
            x, y = y, x  # authority order input: (lat, lon)
        tx, ty = transform_points(self._src, self._dst, x, y)
        if self._dst_swap:
            tx, ty = ty, tx  # authority order output: (lat, lon)
        return float(tx), float(ty), float(z)


# ---------------------------------------------------------------------------
# ogr (geometry containers; boolean ops only where the reference needs
# them for the non-ocean paths)
# ---------------------------------------------------------------------------

wkbLinearRing = 101
wkbPolygon = 102


class Geometry:
    """Polygon/ring container with the operations the reference's ocean
    mask and coverage checks use. Boolean predicates and the clip run on
    axis-aligned envelopes (exact for the reference's rectangular tile /
    file polygons; the same approximation this repo's production
    create_ocean_mask makes — geo/polygon.py). Buffer records the metric
    margin; RasterizeLayer applies it as the exact Euclidean
    distance-transform threshold, matching the production pipeline
    (dilation distributes over polygon unions, so per-polygon dilation
    OR-ed equals dilating the union)."""

    def __init__(self, kind):
        self.kind = kind
        self.points = []
        self.rings = []
        self._srs = None
        self._buffer_m = 0.0

    def AddPoint(self, x, y, z=0.0):
        self.points.append((float(x), float(y)))

    def AddGeometry(self, geom):
        self.rings.append(geom)

    def AssignSpatialReference(self, srs):
        self._srs = srs

    def GetSpatialReference(self):
        return self._srs

    def GetGeometryName(self):
        return 'POLYGON' if self.kind == wkbPolygon else 'LINEARRING'

    def ring_arrays(self):
        if self.kind == wkbLinearRing:
            return [np.array(self.points, dtype=np.float64)]
        return [np.array(r.points, dtype=np.float64) for r in self.rings]

    def _xy(self):
        return np.concatenate(self.ring_arrays(), axis=0)

    def GetEnvelope(self):
        xy = self._xy()
        return (xy[:, 0].min(), xy[:, 0].max(),
                xy[:, 1].min(), xy[:, 1].max())

    def Intersects(self, other):
        ax0, ax1, ay0, ay1 = self.GetEnvelope()
        bx0, bx1, by0, by1 = other.GetEnvelope()
        return bool(ax0 <= bx1 and bx0 <= ax1 and ay0 <= by1 and by0 <= ay1)

    def Within(self, other):
        ax0, ax1, ay0, ay1 = self.GetEnvelope()
        bx0, bx1, by0, by1 = other.GetEnvelope()
        return bool(ax0 >= bx0 and ax1 <= bx1 and ay0 >= by0 and ay1 <= by1)

    def Contains(self, other):
        return other.Within(self)

    def IsValid(self):
        return True

    @classmethod
    def from_ring_arrays(cls, rings, srs=None):
        poly = cls(wkbPolygon)
        for arr in rings:
            ring = cls(wkbLinearRing)
            ring.points = [(float(x), float(y)) for x, y in arr]
            poly.rings.append(ring)
        poly._srs = srs
        return poly

    def Intersection(self, other):
        from proteus_jax.geo.polygon import clip_ring_to_rect
        bx0, bx1, by0, by1 = other.GetEnvelope()
        clipped = []
        for arr in self.ring_arrays():
            c = clip_ring_to_rect(arr, bx0, by0, bx1, by1)
            if c is not None:
                clipped.append(c)
        return Geometry.from_ring_arrays(clipped, self._srs)

    def TransformTo(self, srs):
        out = []
        for arr in self.ring_arrays():
            tx, ty = transform_points(self._srs.crs, srs.crs,
                                      arr[:, 0], arr[:, 1])
            out.append(np.stack([tx, ty], axis=1))
        transformed = Geometry.from_ring_arrays(out, srs)
        self.rings = transformed.rings
        self.points = []
        self.kind = wkbPolygon
        self._srs = srs
        return 0

    def Buffer(self, distance):
        out = Geometry.from_ring_arrays(self.ring_arrays(), self._srs)
        out._buffer_m = self._buffer_m + float(distance)
        return out


class _Feature:
    def __init__(self, geometry):
        self._geometry = geometry

    def GetGeometryRef(self):
        return self._geometry

    def SetGeometry(self, geometry):
        self._geometry = geometry


class _Layer:
    def __init__(self, features):
        self._features = list(features)

    def __iter__(self):
        return iter(self._features)

    def CreateFeature(self, feature):
        self._features.append(feature)


class _ShapefileDataSource:
    def __init__(self, path):
        from proteus_jax.io.shapefile import read_shapefile
        polygons, crs_wkt = read_shapefile(path)
        srs = SpatialReference()
        srs.ImportFromWkt(crs_wkt if crs_wkt
                          else CRS.from_epsg(4326).to_wkt())
        feats = [_Feature(Geometry.from_ring_arrays(p.rings, srs))
                 for p in polygons]
        self._layers = [_Layer(feats)]

    def __iter__(self):
        return iter(self._layers)


class _ShapefileDriver:
    def CreateDataSource(self, path):
        class _OutDS:
            def CreateLayer(self, name, srs, geom_type):
                return _Layer([])
        return _OutDS()


def ogr_Open(path, update=0):
    try:
        return _ShapefileDataSource(path)
    except (OSError, ValueError):
        return None


def ogr_GetDriverByName(name):
    return _ShapefileDriver()


# ---------------------------------------------------------------------------
# module assembly
# ---------------------------------------------------------------------------

def make_modules():
    """Return (gdal, osr, ogr) shim module objects for injection into the
    reference module's namespace (refbridge-loaded)."""
    import types
    g = types.ModuleType('gdal_shim.gdal')
    for name in ('GA_ReadOnly', 'GA_Update', 'GDT_Byte', 'GDT_UInt16',
                 'GDT_Int16', 'GDT_UInt32', 'GDT_Int32', 'GDT_Float32',
                 'GDT_Float64', 'GCI_PaletteIndex', 'GMF_ALL_VALID',
                 'GMF_PER_DATASET', 'TermProgress_nocb',
                 'GetDataTypeName', 'SetConfigOption', 'ColorTable',
                 'GetDriverByName', 'Open', 'Warp', 'Translate',
                 'DEMProcessing', 'BuildVRT', 'BuildVRTOptions',
                 'RasterizeLayer', 'VersionInfo', 'PushErrorHandler',
                 'PopErrorHandler', 'GetLastErrorMsg', 'VSIFOpenL',
                 'VSIFReadL', 'VSIFSeekL', 'VSIFCloseL', 'VSIStatL'):
        setattr(g, name, globals()[name])

    o = types.ModuleType('gdal_shim.osr')
    o.SpatialReference = SpatialReference
    o.CoordinateTransformation = CoordinateTransformation
    o.OAMS_TRADITIONAL_GIS_ORDER = OAMS_TRADITIONAL_GIS_ORDER

    r = types.ModuleType('gdal_shim.ogr')
    r.Geometry = Geometry
    r.wkbLinearRing = wkbLinearRing
    r.wkbPolygon = wkbPolygon
    r.Open = ogr_Open
    r.GetDriverByName = ogr_GetDriverByName
    return g, o, r
