"""One-command network-round harness: retire the two environment-blocked
validation items the moment a network-enabled round exists.

    python tools/network_round.py            # live: download + validate
    python tools/network_round.py --dry-run  # offline plumbing rehearsal

Live mode (needs egress):
  1. downloads the Zenodo workflow scene (record 7714211,
     s30_louisiana_mississippi.tar.gz) — the same dataset the reference's
     own workflow test uses (/root/reference/tests/
     test_dswx_hls_workflow.py:17-48) — runs our full CLI on it in debug
     mode and golden-compares every ref_dir product;
  2. downloads one real HLS v1.4 HDF4 granule (NASA GSFC open mirror;
     override with --hdf4-url), reads it through io/hdf4.py +
     io.hls.load_hls_product_v1, and records band checksums/shapes.

Both results land in NETWORK_ROUND.json at the repo root — commit it.

Dry-run mode needs no network: it rehearses the exact same code paths
over local stand-ins (a synthetic scene laid out like the Zenodo tarball
whose ref_dir holds products from a separate pipeline invocation, and an
HDF4 granule written by tests/hdf4_writer.py), so the harness itself is
known-good before the one network round is spent on it.
"""

import argparse
import hashlib
import json
import os
import shutil
import sys
import tarfile
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))

ZENODO_URL = ('https://zenodo.org/record/7714211/files/'
              's30_louisiana_mississippi.tar.gz')
# HLS v1.4 granules were served openly from the GSFC cluster; any real
# .hdf granule works — override with --hdf4-url if this path has rotted
HDF4_URL = ('https://hls.gsfc.nasa.gov/data/v1.4/S30/2019/15RYP/'
            'HLS.S30.T15RYP.2019224.v1.4.hdf')


def _download(url, dest):
    import urllib.request
    print(f'downloading {url} -> {dest}', flush=True)
    urllib.request.urlretrieve(url, dest)
    return dest


def _sha256(path, limit=None):
    h = hashlib.sha256()
    n = 0
    with open(path, 'rb') as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            n += len(chunk)
            if limit and n >= limit:
                break
    return h.hexdigest()


def run_zenodo_golden(dataset_dir, result):
    """Run the CLI on the scene and compare vs ref_dir (reference
    workflow-test protocol, test_dswx_hls_workflow.py:57-118)."""
    from proteus_jax.cli.dswx_hls import main as dswx_hls_main
    from proteus_jax.runtime.compare import compare_dswx_hls_products

    runconfig = os.path.join(dataset_dir, 'dswx_hls.yaml')
    t0 = time.time()
    dswx_hls_main([runconfig, '--debug'])
    result['pipeline_seconds'] = round(time.time() - t0, 1)

    ref_dir = os.path.join(dataset_dir, 'ref_dir')
    out_dir = os.path.join(dataset_dir, 'output_dir')
    comparisons = {}
    all_ok = True
    for name in sorted(os.listdir(ref_dir)):
        ref_f = os.path.join(ref_dir, name)
        out_f = os.path.join(out_dir, name)
        if name.lower().endswith(('.tif', '.tiff')):
            ok = bool(compare_dswx_hls_products(ref_f, out_f))
        else:  # browse PNG etc: byte comparison
            ok = (os.path.isfile(out_f)
                  and open(ref_f, 'rb').read() == open(out_f,
                                                       'rb').read())
        comparisons[name] = 'identical' if ok else 'MISMATCH'
        all_ok = all_ok and ok
    result['products_compared'] = comparisons
    result['status'] = 'pass' if all_ok and comparisons else 'FAIL'
    return all_ok


def run_hdf4_read(hdf_path, result):
    """Read a real HLS v1 HDF4 granule through the production reader."""
    from proteus_jax.io import hdf4
    from proteus_jax.io.hls import load_hls_product_v1

    with hdf4.Hdf4File(hdf_path) as f:
        result['datasets'] = sorted(f.datasets())[:40]
        result['file_attributes_sample'] = {
            k: str(v)[:120]
            for k, v in list(f.global_attributes().items())[:15]
            if k != 'StructMetadata.0'}

    image_dict = {}
    offset_dict = {}
    scale_dict = {}
    metadata = {}
    ok = load_hls_product_v1(hdf_path, image_dict, offset_dict,
                             scale_dict, metadata, False, flag_debug=True)
    result['load_hls_product_v1'] = bool(ok)
    if ok:
        bands = {}
        for key in ('blue', 'green', 'red', 'nir', 'swir1', 'swir2',
                    'fmask'):
            arr = image_dict.get(key)
            if arr is not None:
                bands[key] = {
                    'shape': list(arr.shape), 'dtype': str(arr.dtype),
                    'sha256_16px': hashlib.sha256(
                        arr[:4, :4].tobytes()).hexdigest()[:16]}
        result['bands'] = bands
        result['sensor'] = metadata.get('SENSOR', '')
    result['status'] = 'pass' if ok else 'FAIL'
    return bool(ok)


# ---------------------------------------------------------------------------
# dry-run stand-ins
# ---------------------------------------------------------------------------

def _make_standin_scene(root, size=192):
    """A synthetic scene in the Zenodo tarball's layout: input_dir,
    ancillaries, dswx_hls.yaml, and a ref_dir produced by a separate
    invocation of the pipeline (so the comparison path is exercised
    against real files, not self-identity in memory)."""
    import synthetic
    scene = os.path.join(root, 's30_standin')
    input_dir = os.path.join(scene, 'input_dir')
    synthetic.make_hls_v2_dataset(input_dir, size=size)
    dem = synthetic.make_dem(input_dir, size=size)
    landcover = synthetic.make_landcover(input_dir, size=size)
    worldcover = synthetic.make_worldcover(input_dir, size=size)

    out_dir = os.path.join(scene, 'output_dir')
    scratch = os.path.join(scene, 'scratch_dir')
    yaml_path = synthetic.write_runconfig(
        os.path.join(scene, 'dswx_hls.yaml'), input_dir, out_dir,
        scratch, dem_file=dem, landcover_file=landcover,
        worldcover_file=worldcover)
    # build ref_dir with one pipeline invocation
    from proteus_jax.cli.dswx_hls import main as dswx_hls_main
    dswx_hls_main([yaml_path, '--debug'])
    ref_dir = os.path.join(scene, 'ref_dir')
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.rename(out_dir, ref_dir)
    return scene


def _make_standin_hdf4(root, size=96):
    import synthetic
    path, _bands = synthetic.make_hls_v1_dataset(root, size=size)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--dry-run', action='store_true',
                    help='rehearse the plumbing with local stand-ins')
    ap.add_argument('--zenodo-url', default=ZENODO_URL)
    ap.add_argument('--hdf4-url', default=HDF4_URL)
    ap.add_argument('--dataset',
                    help='pre-downloaded tarball or extracted scene dir')
    ap.add_argument('--hdf4-file', help='pre-downloaded HDF4 granule')
    ap.add_argument('--out', default=os.path.join(REPO,
                                                  'NETWORK_ROUND.json'))
    ap.add_argument('--workdir', default=None)
    ap.add_argument('--standin-size', type=int, default=192,
                    help='tile size for --dry-run stand-ins')
    args = ap.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix='network_round_')
    os.makedirs(work, exist_ok=True)
    report = {
        'generated': time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime()),
        'mode': 'dry-run' if args.dry_run else 'live',
        'zenodo_golden': {}, 'hdf4_v1': {},
    }

    # --- part 1: Zenodo golden scene ---
    z = report['zenodo_golden']
    try:
        if args.dry_run:
            scene = _make_standin_scene(work, size=args.standin_size)
            z['source'] = 'synthetic stand-in (dry run)'
        else:
            ds = args.dataset
            if not ds:
                ds = _download(args.zenodo_url,
                               os.path.join(work, 's30.tar.gz'))
            if os.path.isdir(ds):
                scene = ds
            else:
                z['tarball_sha256'] = _sha256(ds)
                with tarfile.open(ds) as tf:
                    tf.extractall(work)
                scene = os.path.join(work, 's30_louisiana_mississippi')
            z['source'] = args.zenodo_url
        run_zenodo_golden(scene, z)
    except Exception as e:  # noqa: BLE001 - record and continue
        z['status'] = 'ERROR'
        z['error'] = f'{type(e).__name__}: {e}'

    # --- part 2: real HLS v1 HDF4 granule ---
    h = report['hdf4_v1']
    try:
        if args.dry_run:
            granule = _make_standin_hdf4(work)
            h['source'] = 'tests/hdf4_writer.py stand-in (dry run)'
        else:
            granule = args.hdf4_file or _download(
                args.hdf4_url, os.path.join(work, 'hls_v1.hdf'))
            h['source'] = args.hdf4_url
            h['granule_sha256'] = _sha256(granule)
        run_hdf4_read(granule, h)
    except Exception as e:  # noqa: BLE001
        h['status'] = 'ERROR'
        h['error'] = f'{type(e).__name__}: {e}'

    ok = (z.get('status') == 'pass' and h.get('status') == 'pass')
    report['status'] = 'pass' if ok else 'FAIL'
    with open(args.out, 'w') as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({'network_round': report['status'],
                      'zenodo': z.get('status'),
                      'hdf4_v1': h.get('status'),
                      'artifact': args.out}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
