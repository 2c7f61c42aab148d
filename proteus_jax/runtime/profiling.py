"""Tracing and per-stage timing.

The reference has no profiling subsystem (SURVEY.md section 5: only a GDAL
progress callback); this module adds the equivalents:

- ``StageTimers``: lightweight named wall-clock stage timers, logged as a
  breakdown table at the end of a product run;
- ``device_trace``: context manager around jax.profiler.trace for XLA device
  timeline captures (view with TensorBoard or xprof);
- ``annotate``: jax.profiler.TraceAnnotation pass-through for labeling
  host stages inside a device trace.
"""

import contextlib
import logging
import time

logger = logging.getLogger('dswx_hls')


class StageTimers:
    def __init__(self):
        self.stages = []  # (name, seconds), ordered

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def add(self, name, seconds):
        self.stages.append((name, seconds))

    def total(self):
        return sum(s for _, s in self.stages)

    def report(self, log=None):
        log = log or logger
        total = self.total()
        if not self.stages:
            return
        log.info('stage timing breakdown:')
        for name, s in self.stages:
            pct = 100.0 * s / total if total else 0.0
            log.info(f'    {name:<28} {s:8.2f}s  {pct:5.1f}%')
        log.info(f'    {"total":<28} {total:8.2f}s')


@contextlib.contextmanager
def device_trace(trace_dir):
    """Capture a jax.profiler trace into ``trace_dir`` (no-op when
    trace_dir is falsy)."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
    logger.info(f'device trace written to: {trace_dir}')


def annotate(name):
    """Label a host-side region inside a device trace."""
    import jax
    return jax.profiler.TraceAnnotation(name)
