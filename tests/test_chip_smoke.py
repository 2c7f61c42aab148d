"""chip_smoke.py on the CPU: it refuses to report a result here, and every
part of it works at a small size.

The script's real run needs the card; these tests run its phases on
small synthetic tiles with the card lookup stubbed, check the parsing of
``nvidia-smi``, the choice of phases, the last line's contract and the
comparison helper that decides every phase.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

from proteus_jax.utils import gpu  # noqa: E402


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(chip_smoke, 'card_line', lambda: 'no card (CPU)')


def _last_line(text):
    lines = text.strip().splitlines()
    return lines[-1] if lines else ''


def test_exits_nonzero_on_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
                          '--workdir', str(tmp_path / 'w')],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in _last_line(out.stdout)
    assert 'no GPU' in out.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in _last_line(out.stdout)


@pytest.mark.parametrize('text,want', [
    ('NVIDIA H100 80GB HBM3, 700.00 W\n',
     [('NVIDIA H100 80GB HBM3', '700.00 W')]),
    ('NVIDIA H100 80GB HBM3, 500.00 W', [('NVIDIA H100 80GB HBM3',
                                         '500.00 W')]),
    ('NVIDIA H100 PCIe, [N/A]\n', [('NVIDIA H100 PCIe', '[N/A]')]),
    ('A, 1 W\n\nB, 2 W\n', [('A', '1 W'), ('B', '2 W')]),
    ('Card, model 2, 300.00 W', [('Card, model 2', '300.00 W')]),
])
def test_parse_nvidia_smi(text, want):
    got = gpu.parse_nvidia_smi(text)
    assert [(c['name'], c['power_limit']) for c in got] == want


def test_parse_nvidia_smi_rejects_other_lines():
    with pytest.raises(ValueError):
        gpu.parse_nvidia_smi('No devices were found')


def test_four_selects_only_its_phase(monkeypatch, tmp_path):
    assert chip_smoke.selected_phases(
        chip_smoke.parse_args(['--four'])) == ('four',)
    assert chip_smoke.selected_phases(
        chip_smoke.parse_args([])) == chip_smoke.PHASES
    assert 'four' not in chip_smoke.PHASES
    ran = []
    monkeypatch.setattr(chip_smoke, 'PHASE_FUNCS', {
        p: (lambda ctx, p=p: ran.append(p))
        for p in chip_smoke.PHASES + chip_smoke.FOUR_PHASES})
    work = tmp_path / 'w'
    chip_smoke.run_phases(chip_smoke.selected_phases(
        chip_smoke.parse_args(['--four'])), 16, str(work))
    assert ran == ['four']
    assert not work.exists()


class _Device:
    platform = 'gpu'
    device_kind = 'NVIDIA H100 80GB HBM3'


@pytest.mark.parametrize('count', [1, 4])
def test_last_line_has_exactly_the_contract_keys(count):
    line = json.loads(chip_smoke.final_line([_Device()] * count))
    assert line == {'ok': True,
                    'device': {'platform': 'gpu',
                               'kind': 'NVIDIA H100 80GB HBM3',
                               'count': count}}


def test_mismatch_helper_catches_one_pixel():
    a = np.random.default_rng(3).integers(0, 256, (64, 48)).astype(np.uint8)
    b = a.copy()
    assert chip_smoke.mismatches(a, b) == 0
    b[17, 5] ^= 1
    assert chip_smoke.mismatches(a, b) == 1
    f = np.array([[1.0, np.nan], [np.nan, 2.0]], np.float32)
    g = f.copy()
    assert chip_smoke.mismatches(f, g) == 0  # NaN equals NaN
    g[1, 0] = 0.0
    assert chip_smoke.mismatches(f, g) == 1
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.mismatches(a, a[:-1])


def test_device_phase_refuses_the_cpu(tmp_path):
    with pytest.raises(chip_smoke.PhaseFailed, match='not gpu'):
        chip_smoke.phase_device({'inputs': chip_smoke.Inputs(
            str(tmp_path), 16)})


def test_exact_phase_small_n_passes_on_cpu(no_card, tmp_path, capfd):
    chip_smoke.phase_exact({'inputs': chip_smoke.Inputs(str(tmp_path), 64)},
                           ratio_n=1 << 10)
    record = json.loads(_last_line(capfd.readouterr().out))
    assert record['phase'] == 'exact'
    assert all(r['n'] == 5 << 10 and r['mismatches'] == 0
               for r in record['ratio_cmp'])
    assert len(record['hillshade']) == 3
    assert all(isinstance(v, bool) for k, v in record['probes'].items()
               if k.endswith(('contracted', 'flushed')))


def test_exact_phase_catches_wrong_comparisons(no_card, tmp_path,
                                               monkeypatch):
    from proteus_jax.core import f32exact
    monkeypatch.setattr(f32exact, 'ratio_cmp',
                        lambda num, den, b: num * 0 != 0)
    with pytest.raises(chip_smoke.PhaseFailed, match='exactness'):
        chip_smoke.phase_exact({'inputs': chip_smoke.Inputs(
            str(tmp_path), 32)}, ratio_n=1 << 8)


@pytest.mark.parametrize('phase', ['pge', 'campaign', 'scaled',
                                   'variants'])
def test_phase_passes_at_small_size_on_cpu(no_card, tmp_path, capfd,
                                           phase):
    chip_smoke.run_phases([phase], 96, str(tmp_path / 'w'))
    out = capfd.readouterr().out
    records = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith('{"phase"')]
    assert [r['phase'] for r in records] == [phase]
    assert not (tmp_path / 'w').exists()


def test_four_phase_on_virtual_devices(no_card, tmp_path, capfd):
    chip_smoke.run_phases(['four'], 40, str(tmp_path / 'w'))
    record = json.loads([ln for ln in capfd.readouterr().out.splitlines()
                         if ln.startswith('{"phase"')][-1])
    assert record['dp']['shard_devices']['WTR'] == [0, 1, 2, 3]
    assert record['dp_x_sp']['mesh'] == [2, 2]
