"""Retry for transient transport errors of a remote device.

Port of ``item_alignment_tpu/utils/retry.py``.  A call that donates none of
its inputs is idempotent and safe to retry; a train step that updates its
state in place must not be wrapped, since a retry would replay it on the
updated state.  Errors whose text names none of ``TRANSIENT_MARKERS`` (out of
memory, shape errors, a refused launch) re-raise at once.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

from item_alignment_torch.utils.logging import logger

T = TypeVar("T")

TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "Broken pipe",
    "remote_compile",
    "DEADLINE_EXCEEDED",
    "Connection refused",
    "Connection reset",
    "Socket closed",
    "failed to connect",
)


def retry_transient(fn: Callable[[], T], attempts: int = 4,
                    wait: float = 20.0) -> T:
    """Run ``fn``, retrying up to ``attempts`` times when its error is
    transient.  The last attempt's error propagates whatever it is."""
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:
            transient = any(t in str(e) for t in TRANSIENT_MARKERS)
            if i == attempts - 1 or not transient:
                raise
            logger.warning(
                f"transient device error ({e}); retry {i + 1}/"
                f"{attempts - 1} in {wait:.0f}s")
            time.sleep(wait)
    raise AssertionError("unreachable")
