"""The runconfig YAML loader against PyYAML, which is the oracle here only.

Every ``.yaml`` file of the repository and the runconfigs that
``synthetic.write_runconfig`` writes must load to exactly what
``yaml.safe_load_all`` gives; constructs outside the supported subset
must raise instead of loading to something else.
"""

import glob
import math
import os

import pytest

import synthetic

from proteus_jax.config import yaml_subset

yaml = pytest.importorskip('yaml')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_YAML = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, '**', '*.yaml'), recursive=True)
    if '.git' not in p.split(os.sep))


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def test_repo_has_yaml_files():
    assert 'proteus_jax/config/defaults/dswx_hls.yaml' in REPO_YAML
    assert 'proteus_jax/config/schemas/dswx_hls.yaml' in REPO_YAML


@pytest.mark.parametrize('path', REPO_YAML)
def test_repo_yaml_matches_pyyaml(path):
    with open(os.path.join(ROOT, path)) as fh:
        text = fh.read()
    want = list(yaml.safe_load_all(text))
    got = yaml_subset.load_all(text)
    assert _same(got, want)


RUNCONFIGS = {
    'minimal': {},
    'all_ancillaries': dict(dem_file='/a/dem.tif',
                            landcover_file='/a/landcover.tif',
                            worldcover_file='/a/worldcover.tif',
                            shoreline_shapefile='/a/shoreline.shp',
                            check_coverage=True, apply_ocean_masking=True),
    'processing': dict(extra_processing={
        'mask_adjacent_to_cloud_mode': "'cover'",
        'shadow_masking_algorithm': 'otsu', 'min_slope_angle': -10,
        'save_dem': 'False', 'forest_mask_landcover_classes': '[20, 50]'}),
    'thresholds': dict(thresholds={'wigt': 0.2, 'pswt_1_nir': 1200,
                                   'awgt': -0.05}),
}


@pytest.mark.parametrize('name', sorted(RUNCONFIGS))
def test_runconfig_matches_pyyaml(name, tmp_path):
    path = synthetic.write_runconfig(
        str(tmp_path / 'rc.yaml'), str(tmp_path / 'in'),
        str(tmp_path / 'out'), str(tmp_path / 'scratch'),
        **RUNCONFIGS[name])
    with open(path) as fh:
        want = yaml.safe_load(fh)
    assert _same(yaml_subset.load_file(path), want)


SCALARS = ['a: yes', 'a: No', 'a: on', 'a: ~', 'a: null', 'a:', 'a: 0x1f',
           'a: 017', 'a: 1_000', 'a: -12', 'a: +3', 'a: 1.5e+3', 'a: .5',
           'a: -.inf', 'a: .nan', "a: 'it''s'", 'a: "tab\\there"',
           'a: plain text # comment', 'a: [1, "b", c]',
           'a: []', "'quoted key': 1", 'a: x#y']


@pytest.mark.parametrize('text', SCALARS)
def test_scalars_resolve_like_pyyaml(text):
    assert _same(yaml_subset.load(text), yaml.safe_load(text))


def test_nested_blocks_and_documents():
    text = ('---\nrunconfig:\n  groups:\n    list:\n    - 1\n    - two\n'
            '    - k: v\n      k2: [a, b]\n---\nsecond: doc\n')
    assert _same(yaml_subset.load_all(text), list(yaml.safe_load_all(text)))


@pytest.mark.parametrize('text', ['a: &anchor 1', 'a: {b: 1}', 'a: |\n  x',
                                  'a: !!str 1', 'a:\n\tb: 1',
                                  'a: 2021-07-29',
                                  'a: "open'])
def test_unsupported_constructs_raise(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.load(text)
