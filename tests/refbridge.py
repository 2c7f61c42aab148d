"""Load the reference nasa/PROTEUS science module as an executable oracle.

The reference (read-only at /root/reference) imports GDAL/yamale/ruamel at
module scope, none of which exist in this environment. Its *science core*
(diagnostic tests, interpretation, masking, cloud, shadow — everything our
device chain re-implements) is pure NumPy/SciPy, so we stub the unavailable
modules with inert placeholders and import the real module. Tests built on
this bridge compare our chain against the reference's actual executing
code, not against this repo's own re-implementation (tests/oracle.py),
closing the shared-misreading loophole.

No reference code is copied anywhere — the module is imported in place and
only *called*. Everything is skipped cleanly when the reference checkout is
absent (e.g. when this repo is used standalone).
"""

import importlib
import sys
import types

REFERENCE_SRC = '/root/reference/src'

_CACHED = None
_FAILED = None


class _InertAttr:
    """Placeholder object whose attribute accesses return callables that
    raise if actually invoked — science functions never touch these."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, item):
        full = f'{self._name}.{item}'

        def _unavailable(*args, **kwargs):
            raise RuntimeError(
                f'{full} is not available in the test environment '
                '(GDAL-backed reference I/O is stubbed out)')

        return _unavailable


def _make_stub(name, **attrs):
    mod = types.ModuleType(name)
    for key, value in attrs.items():
        setattr(mod, key, value)
    return mod


def load_reference_dswx():
    """Import and return the reference's proteus.dswx_hls module.

    Returns None when the reference checkout is unavailable; callers
    should pytest.skip in that case.
    """
    global _CACHED, _FAILED
    if _CACHED is not None:
        return _CACHED
    if _FAILED is not None:
        return None

    import os
    if not os.path.isdir(REFERENCE_SRC):
        _FAILED = 'reference checkout not present'
        return None

    stubs = {}
    if 'yamale' not in sys.modules:
        stubs['yamale'] = _make_stub(
            'yamale',
            make_schema=_InertAttr('yamale').make_schema,
            make_data=_InertAttr('yamale').make_data,
            validate=_InertAttr('yamale').validate,
            YamaleError=RuntimeError)
    if 'ruamel' not in sys.modules:
        ruamel = _make_stub('ruamel')
        ruamel_yaml = _make_stub('ruamel.yaml', YAML=_InertAttr('ruamel.yaml.YAML'))
        ruamel.yaml = ruamel_yaml
        stubs['ruamel'] = ruamel
        stubs['ruamel.yaml'] = ruamel_yaml
    if 'osgeo' not in sys.modules:
        osgeo = _make_stub('osgeo')
        gdal = _make_stub('osgeo.gdal')
        osr = _make_stub('osgeo.osr')
        ogr = _make_stub('osgeo.ogr')
        gdalconst = _make_stub('osgeo.gdalconst', GDT_Float32=6, GDT_Byte=1)
        for attr in ('UseExceptions', 'DontUseExceptions'):
            setattr(gdal, attr, lambda *a, **k: None)
        # real GDAL numeric constants: some are captured at import time as
        # function default arguments (e.g. _save_array's output_dtype,
        # dswx_hls.py:2895), so they must be correct even in inert mode
        for name, value in (('GDT_Byte', 1), ('GDT_UInt16', 2),
                            ('GDT_Int16', 3), ('GDT_UInt32', 4),
                            ('GDT_Int32', 5), ('GDT_Float32', 6),
                            ('GDT_Float64', 7), ('GA_ReadOnly', 0),
                            ('GA_Update', 1), ('GCI_PaletteIndex', 2)):
            setattr(gdal, name, value)
        # functional ColorTable so the reference's pure-logic color-table
        # builders (dswx_hls.py:1381-1636,2427-2575) execute for real
        class _ColorTable:
            def __init__(self):
                self.entries = {}

            def SetColorEntry(self, value, rgba):
                rgba = tuple(rgba)
                if len(rgba) == 3:
                    rgba = rgba + (255,)
                self.entries[int(value)] = rgba

            def GetColorEntry(self, value):
                return self.entries.get(int(value))
        gdal.ColorTable = _ColorTable
        # anything else accessed at call time raises loudly
        inert = _InertAttr('osgeo.gdal')
        gdal.__getattr__ = lambda item, _i=inert: getattr(_i, item)
        osgeo.gdal = gdal
        osgeo.osr = osr
        osgeo.ogr = ogr
        osgeo.gdalconst = gdalconst
        stubs.update({'osgeo': osgeo, 'osgeo.gdal': gdal, 'osgeo.osr': osr,
                      'osgeo.ogr': ogr, 'osgeo.gdalconst': gdalconst})
    if 'mgrs' not in sys.modules:
        stubs['mgrs'] = _make_stub('mgrs', MGRS=_InertAttr('mgrs.MGRS'))

    sys.modules.update(stubs)
    if REFERENCE_SRC not in sys.path:
        sys.path.insert(0, REFERENCE_SRC)
    try:
        _CACHED = importlib.import_module('proteus.dswx_hls')
    except Exception as exc:  # pragma: no cover - environment dependent
        _FAILED = f'reference import failed: {exc!r}'
        return None
    return _CACHED


def reference_thresholds(values):
    """Build a reference HlsThresholds populated from a mapping."""
    ref = load_reference_dswx()
    t = ref.HlsThresholds()
    for key, val in values.items():
        setattr(t, key, val)
    return t
