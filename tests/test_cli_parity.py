"""CLI argument-surface parity vs the reference's executing argparse.

The reference builds its parser in pure argparse (dswx_hls.py:411-702),
which refbridge can import and execute — so the full option surface
(dests, option strings, defaults, choices, arities, action kinds) is
compared programmatically rather than by eyeball.

One deliberate deviation: seven reference ``add_argument`` calls are
missing a comma between adjacent option-string literals (e.g.
``'--bwtr' '--output-binary-water'`` at dswx_hls.py:496-497), fusing
them into a single unusable literal ``--bwtr--output-binary-water``.
Thanks to argparse prefix matching the short form still works there, but
the long form does not. This repo registers both strings properly, a
strict superset of what the reference accepts.
"""

import pytest

import refbridge

from proteus_jax.cli.args import get_dswx_hls_cli_parser

REF = refbridge.load_reference_dswx()

pytestmark = pytest.mark.skipif(
    REF is None, reason='reference checkout not available')


def _split_fused(opt):
    """Split a fused option literal on interior '--' boundaries."""
    if not opt.startswith('--'):
        return [opt]
    parts = opt[2:].split('--')
    return ['--' + p for p in parts if p]


def _surface(parser, split_fused=False):
    out = {}
    for a in parser._actions:
        opts = []
        for o in a.option_strings:
            opts.extend(_split_fused(o) if split_fused else [o])
        out[a.dest] = {
            'options': tuple(sorted(opts)),
            'default': a.default,
            'choices': tuple(a.choices) if a.choices else None,
            'nargs': a.nargs,
            'kind': type(a).__name__,
            'type': getattr(a.type, '__name__', a.type),
        }
    return out


def test_option_surface_matches_reference():
    ref = _surface(REF.get_dswx_hls_cli_parser(), split_fused=True)
    ours = _surface(get_dswx_hls_cli_parser())
    assert set(ours) == set(ref), (
        f'dest mismatch: only-ref={set(ref) - set(ours)}, '
        f'only-ours={set(ours) - set(ref)}')
    for dest in ref:
        assert ours[dest] == ref[dest], (
            f'--{dest}: ours={ours[dest]} ref={ref[dest]}')


def test_every_reference_usable_option_parses_here():
    """Every option string a user could pass to the reference (including
    unambiguous prefixes of the fused literals) is accepted verbatim."""
    ref_parser = REF.get_dswx_hls_cli_parser()
    ours = get_dswx_hls_cli_parser()
    our_opts = {o for a in ours._actions for o in a.option_strings}
    for a in ref_parser._actions:
        for o in a.option_strings:
            for piece in _split_fused(o):
                assert piece in our_opts, (
                    f'{piece} (from reference literal {o!r}) missing')
