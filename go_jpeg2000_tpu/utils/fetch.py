"""Asynchronous device->host fetch.

`fetch_async` starts the copy of a device array to host memory and returns
a handle; `gather` blocks on it and returns the numpy array.  Starting the
copy right after dispatch lets it overlap host work on earlier chunks.  Host
numpy arrays pass through untouched.

No reference analog: the reference is a single-process CPU library
(/root/reference/encoder.go) with no device boundary to cross.
"""
from __future__ import annotations

import numpy as np


def fetch_async(x):
    """Start the device->host copy of `x`; returns the handle for
    `gather`."""
    if hasattr(x, "copy_to_host_async"):
        x.copy_to_host_async()
    return x


def gather(handle) -> np.ndarray:
    """Block on a `fetch_async` handle and return the host array."""
    return np.asarray(handle)
