"""CLI timing decorator + optional jax profiler tracing.

Reference parity: cli_utils.py:15-28 (h|m|s wall-clock logging).  Extended
with a `DOPPEL_PROFILE_DIR` env hook that wraps the command in a
``jax.profiler.trace`` for device timeline capture (SURVEY.md §5 tracing plan).
"""

from __future__ import annotations

import functools
import logging
import os
import time

LOGGER = logging.getLogger(__name__)


def time_usage(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        profile_dir = os.environ.get("DOPPEL_PROFILE_DIR")
        start = time.time()
        if profile_dir:
            import jax

            with jax.profiler.trace(profile_dir):
                result = func(*args, **kwargs)
        else:
            result = func(*args, **kwargs)
        elapsed = time.time() - start
        hours, rem = divmod(elapsed, 3600)
        minutes, seconds = divmod(rem, 60)
        LOGGER.info(
            "Elapsed time [%s]: %dh | %dm | %.2fs",
            func.__name__, int(hours), int(minutes), seconds,
        )
        return result

    return wrapper
