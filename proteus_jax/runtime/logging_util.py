"""Logging setup: console + optional file handler, stdout/stderr capture.

Mirrors the reference logging subsystem (dswx_hls.py:4083-4175): a module
logger named 'dswx_hls', an optional PGE-style full log format with the
fixed error code 999999, and a stream redirector that routes stray
print()/stderr output into the logger.
"""

import logging
import sys

logger = logging.getLogger('dswx_hls')


class StreamToLogger:
    """File-like object that forwards complete lines to a logger."""

    def __init__(self, target_logger, level, prefix=''):
        self.logger = target_logger
        self.level = level
        self.prefix = prefix
        self.buffer = ''

    def write(self, message):
        if '\n' not in message:
            self.buffer += message
            return
        message = self.buffer + message
        lines = message.split('\n')
        if not message.endswith('\n'):
            self.buffer = lines[-1]
            lines = lines[:-1]
        else:
            self.buffer = ''
        for line in lines:
            if line:
                self.logger.log(self.level, self.prefix + line)

    def flush(self):
        if self.buffer:
            self.logger.log(self.level, self.buffer)
        self.buffer = ''


_HANDLERS = []


def create_logger(log_file=None, full_log_formatting=None,
                  capture_std_streams=True):
    """Configure the 'dswx_hls' logger; optionally add a file handler and
    redirect sys.stdout/sys.stderr into it.

    A later call in the same process replaces the handlers of the earlier
    one, so that several runs in one process log each line once."""
    logger.setLevel(logging.DEBUG)
    while _HANDLERS:
        old = _HANDLERS.pop()
        logger.removeHandler(old)
        old.close()

    ch = logging.StreamHandler(sys.__stdout__)
    ch.setLevel(logging.DEBUG)
    if full_log_formatting:
        msgfmt = ('%(asctime)s.%(msecs)03d, %(levelname)s, DSWx-HLS, '
                  '%(module)s, 999999, %(pathname)s:%(lineno)d,'
                  ' "%(message)s"')
        formatter = logging.Formatter(msgfmt, '%Y-%m-%d %H:%M:%S')
    else:
        formatter = logging.Formatter('%(message)s')
    ch.setFormatter(formatter)
    _HANDLERS.append(ch)

    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        _HANDLERS.append(fh)
    for handler in _HANDLERS:
        logger.addHandler(handler)

    if capture_std_streams:
        sys.stdout = StreamToLogger(logger, logging.INFO)
        sys.stderr = StreamToLogger(logger, logging.ERROR,
                                    prefix='[StdErr] ')
    return logger
