"""The GPU a measurement runs on: a hard requirement and its identity.

Measurement paths (``bench.py``, ``bench_e2e.py``, ``chip_smoke.py``)
call ``require_gpu`` first: a number taken on another backend must never
be reported as a device number, so they stop instead of falling back.
``card_identity`` reads the card's name and power limit, which every
reported device number carries (a card set below its maximum power runs
slower under load).
"""

import subprocess

NVIDIA_SMI_QUERY = ['nvidia-smi', '--query-gpu=name,power.limit',
                    '--format=csv,noheader']


class NoGpuError(RuntimeError):
    pass


def require_gpu():
    """Return ``jax.devices()``; raise NoGpuError unless they are GPUs."""
    import jax
    try:
        devices = jax.devices()
    except RuntimeError as exc:
        raise NoGpuError(f'JAX found no backend: {exc}') from exc
    if devices[0].platform != 'gpu':
        raise NoGpuError(f'JAX found no GPU (platform '
                         f'{devices[0].platform!r}); this measurement '
                         'runs only on the card')
    return devices


def device_record(devices):
    """The device as JAX reports it: platform, kind and count."""
    return {'platform': devices[0].platform,
            'kind': devices[0].device_kind, 'count': len(devices)}


def parse_nvidia_smi(text):
    """``name, power.limit`` csv lines -> [{'name', 'power_limit'}].

    ``power_limit`` keeps nvidia-smi's own text (e.g. '700.00 W' or
    '[N/A]'); blank lines are skipped."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, power = line.rpartition(',')
        if not sep:
            raise ValueError(f'not a name,power.limit line: {line!r}')
        cards.append({'name': name.strip(), 'power_limit': power.strip()})
    return cards


def card_identity():
    """nvidia-smi's ``name, power.limit`` lines for the visible cards."""
    return subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
