"""The share of the device LOBPCG's step pieces in the traced window that
ran as CUDA graph replays (``raleigh.lobpcg.replay`` spans) and not
eagerly (``raleigh.lobpcg.piece`` spans), in %; None where the window
holds neither."""

from ..spans import count


def read(record):
    replays = count(record, 'raleigh.lobpcg.replay') or 0.0
    pieces = count(record, 'raleigh.lobpcg.piece') or 0.0
    if replays + pieces == 0:
        return None
    return 100.0 * replays / (replays + pieces)
