"""Minimal GDAL VRT (virtual raster) writer.

Supports the reference's `.vrt` output mode (gdal.BuildVRT at
dswx_hls.py:5400-5404): an XML document stacking the saved layer files as
bands of one virtual dataset.
"""

import xml.sax.saxutils

from proteus_jax.io.tiff import TiffReader

_GDAL_DTYPES = {'uint8': 'Byte', 'uint16': 'UInt16', 'int16': 'Int16',
                'uint32': 'UInt32', 'int32': 'Int32',
                'float32': 'Float32', 'float64': 'Float64'}


def build_vrt(output_file, input_files, resample_alg='nearest'):
    if not input_files:
        raise ValueError('build_vrt: no input files')
    with TiffReader(input_files[0]) as r:
        width, length = r.width, r.length
        gt = r.geotransform()
        epsg = r.epsg()

    lines = [f'<VRTDataset rasterXSize="{width}" rasterYSize="{length}">']
    if epsg:
        lines.append(f'  <SRS>EPSG:{epsg}</SRS>')
    gt_str = ', '.join(repr(float(v)) for v in
                       (gt[0], gt[1], gt[2], gt[3], gt[4], gt[5]))
    lines.append(f'  <GeoTransform>{gt_str}</GeoTransform>')

    band_index = 0
    for path in input_files:
        with TiffReader(path) as r:
            nbands = r.count
            dtype = _GDAL_DTYPES.get(r.dtype.name, 'Byte')
            nodata = r.nodata()
        for b in range(nbands):
            band_index += 1
            lines.append(f'  <VRTRasterBand dataType="{dtype}" '
                         f'band="{band_index}">')
            if nodata is not None:
                lines.append(f'    <NoDataValue>{nodata}</NoDataValue>')
            esc = xml.sax.saxutils.escape(path)
            lines.append('    <SimpleSource '
                         f'resampling="{resample_alg}">')
            lines.append(f'      <SourceFilename relativeToVRT="0">{esc}'
                         '</SourceFilename>')
            lines.append(f'      <SourceBand>{b + 1}</SourceBand>')
            lines.append('    </SimpleSource>')
            lines.append('  </VRTRasterBand>')
    lines.append('</VRTDataset>')
    with open(output_file, 'w') as fh:
        fh.write('\n'.join(lines) + '\n')
    return output_file
