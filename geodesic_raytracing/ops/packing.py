"""O(N) bucket partitions — replacements for argsort.

The refinement-block selector (render/pipeline.py) and the EWA
probe-pixel selector (render/background.py) only need *grouping by a
small integer key*, which a stable counting partition does in
O(N * n_buckets) elementwise work instead of a full sort.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def bucket_sort_perm(bucket: Array, n_buckets: int) -> tuple[Array, Array]:
    """Stable ascending partition by a small integer key.

    ``bucket``: (N,) int32 in [0, n_buckets).  Returns ``(perm, dest)``:
    ``x[perm]`` is grouped by bucket (stable within a bucket) and
    ``x_grouped[dest]`` restores the original order.

    All per-bucket ranks come from ONE (n_buckets, N) cumsum — a single
    vectorised scan instead of n_buckets sequential (N,) cumsums, so the
    bucket count can grow (finer cost keys) without adding scan passes.
    """
    n = bucket.shape[0]
    onehot = bucket[None, :] == jnp.arange(n_buckets, dtype=bucket.dtype)[
        :, None
    ]
    ranks = jnp.cumsum(onehot.astype(jnp.int32), axis=1)  # (B, N)
    counts = ranks[:, -1]
    offsets = jnp.cumsum(counts) - counts  # exclusive prefix
    dest = jnp.sum(
        jnp.where(onehot, offsets[:, None] + ranks - 1, 0), axis=0
    ).astype(jnp.int32)
    perm = jnp.zeros((n,), dtype=jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32)
    )
    return perm, dest
