"""Golden test against the reference's shipped workflow products — the
Zenodo dataset (record 7714211) that the reference test suite itself
downloads (reference tests/test_dswx_hls_workflow.py:17-118).

Two ways to enable (disabled by default — this environment has neither
network access nor a local copy):

- PROTEUS_ZENODO_DATASET=/path/to/s30_louisiana_mississippi
  points at an extracted copy of the tarball (or at the .tar.gz itself);
- PROTEUS_ZENODO_TEST=1 downloads it from Zenodo first.

Either way the full CLI runs on the real S30 Louisiana/Mississippi scene
(debug-crop mode, like the reference test) and every file in ref_dir is
compared pixel-exactly (atol 1e-6 + metadata) against our output.
"""

import os
import tarfile

import pytest

_LOCAL = os.environ.get('PROTEUS_ZENODO_DATASET')
_LIVE = os.environ.get('PROTEUS_ZENODO_TEST')

pytestmark = pytest.mark.skipif(
    not (_LOCAL or _LIVE),
    reason='golden-products test disabled (set PROTEUS_ZENODO_DATASET='
           '<path> for a local copy, or PROTEUS_ZENODO_TEST=1 to '
           'download from Zenodo)')

ZENODO_URL = ('https://zenodo.org/record/7714211/files/'
              's30_louisiana_mississippi.tar.gz')


def _dataset_dir(tmp_path):
    if _LOCAL:
        path = _LOCAL
        if path.endswith(('.tar.gz', '.tgz', '.tar')):
            with tarfile.open(path) as tf:
                tf.extractall(str(tmp_path))
            return str(tmp_path / 's30_louisiana_mississippi')
        return path
    import urllib.request
    tarball = str(tmp_path / 's30.tar.gz')
    urllib.request.urlretrieve(ZENODO_URL, tarball)
    with tarfile.open(tarball) as tf:
        tf.extractall(str(tmp_path))
    return str(tmp_path / 's30_louisiana_mississippi')


def test_workflow_against_reference_products(tmp_path):
    dataset_dir = _dataset_dir(tmp_path)

    from proteus_jax.cli.dswx_hls import main as dswx_hls_main
    from proteus_jax.runtime.compare import compare_dswx_hls_products

    runconfig = os.path.join(dataset_dir, 'dswx_hls.yaml')
    dswx_hls_main([runconfig, '--debug'])

    ref_dir = os.path.join(dataset_dir, 'ref_dir')
    out_dir = os.path.join(dataset_dir, 'output_dir')
    for name in sorted(os.listdir(ref_dir)):
        assert compare_dswx_hls_products(
            os.path.join(ref_dir, name), os.path.join(out_dir, name)), name
