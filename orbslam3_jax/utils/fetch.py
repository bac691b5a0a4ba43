"""Batched device->host transfers.

`fetch` starts the copy of every jax.Array leaf (`copy_to_host_async`)
before materializing any of them, so a bundle of results costs one wait
instead of one per array. Every multi-array pull goes through here.
"""

from __future__ import annotations

import jax
import numpy as np


def fetch(*vals):
    """np.asarray every jax.Array leaf in `vals`, with all device->host
    copies in flight concurrently. Returns the same structure(s); a
    single argument returns its converted self."""
    flat = [jax.tree_util.tree_flatten(v) for v in vals]
    for leaves, _ in flat:
        for x in leaves:
            if isinstance(x, jax.Array):
                x.copy_to_host_async()
    out = [
        td.unflatten([np.asarray(x) if isinstance(x, jax.Array) else x
                      for x in leaves])
        for leaves, td in flat
    ]
    return out[0] if len(out) == 1 else tuple(out)
