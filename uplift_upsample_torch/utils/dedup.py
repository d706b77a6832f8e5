"""Fast exact row deduplication for the shared-spatial eval path.

Copied from the JAX package's `utils/dedup.py`. `np.unique(axis=0)` on the
(B·N, 34) float32 frame matrix memcmp-sorts 136-byte void keys, which is
slow. This module dedups via a vectorized 64-bit mixing hash over the row
bytes, then VERIFIES the grouping with an exact bytewise compare against each
group's representative; on any mismatch (a hash collision, ~2^-64 per batch,
or adversarial input) it falls back to the exact `np.unique(axis=0)`. The
result is therefore always exact.

Equality semantics: bytewise, after canonicalizing -0.0 → +0.0. Callers build
masked frames as `x * mask`, which produces -0.0 wherever x was negative — so
value-zero rows carry random sign-bit byte patterns. Canonicalizing merges
them all with the true zero row (the property the shared-spatial eval relies
on: every masked frame shares ONE computed feature row), and it is safe for
feature sharing because the model's input ops (Dense matmuls) are value-level
functions of their inputs. It also keeps the hash strong: sign bits live in
uint64 bit positions 31/63, where a per-column multiply-accumulate hash
collapses to ~1 bit of entropy, so distinct sign patterns would collide and
force the slow exact fallback. NaN payloads still compare reliably
(bytewise, NaN + 0.0 preserves the payload).
"""

from __future__ import annotations

import numpy as np

# Per-column odd multipliers (splitmix64-style constants) so that permuted
# rows mix to different hashes; wraparound multiply is the intended mixing.
_MIX = np.uint64(0x9E3779B97F4A7C15)
_FINAL_A = np.uint64(0xBF58476D1CE4E5B9)
_FINAL_B = np.uint64(0x94D049BB133111EB)


def _column_constants(ncols: int) -> np.ndarray:
    # Deterministic odd constants per column
    c = (np.arange(1, ncols + 1, dtype=np.uint64) * _MIX) | np.uint64(1)
    return c


def dedup_rows(flat: np.ndarray):
    """Exact row dedup. flat: (R, D) array whose row byte-length is a
    multiple of 8. Returns (uniq (U, D), inverse (R,)) with
    uniq[inverse] bytewise-equal to flat (after -0.0 → +0.0 canonicalization
    for float dtypes). uniq rows appear in hash order (NOT lexicographic —
    callers must not rely on ordering)."""
    flat = np.ascontiguousarray(flat)
    if flat.dtype.kind == "f":
        # -0.0 + 0.0 == +0.0 (round-to-nearest); every other value, including
        # NaN payloads, is bit-preserved. One vectorized pass.
        flat = flat + flat.dtype.type(0.0)
    r, d = flat.shape
    assert (d * flat.dtype.itemsize) % 8 == 0, "row bytes must be 8-aligned"
    with np.errstate(over="ignore"):
        b = flat.view(np.uint64).reshape(r, -1)
        # Mix each element BEFORE summing: without this, inputs whose entropy
        # sits in high bit positions (e.g. float sign bits at 31/63) collapse
        # under the multiply-accumulate (c << 63 keeps only a parity bit) and
        # collide, forcing the slow exact fallback.
        m = b * _column_constants(b.shape[1])
        m ^= m >> np.uint64(29)
        m *= _FINAL_A
        m ^= m >> np.uint64(32)
        h = m.sum(axis=1, dtype=np.uint64)
        # splitmix64-style finalizer: break up linear structure
        h ^= h >> np.uint64(30)
        h *= _FINAL_A
        h ^= h >> np.uint64(27)
        h *= _FINAL_B
        h ^= h >> np.uint64(31)
    _, first_idx, inv = np.unique(h, return_index=True, return_inverse=True)
    bu = b[first_idx]
    if (b == bu[inv]).all():
        return flat[first_idx], inv
    # Hash collision: exact (slow) fallback
    return np.unique(flat, axis=0, return_inverse=True)
