"""Least bytes and operations of a query batch and of its step 1 (K5) with
int8 user rows, thresholds and table and their per-row parameters. The
step-1 count is a frozen copy of `chip_smoke.py`'s K5 count of its phase 5
(`need`) as of commit 0ea130a."""
from __future__ import annotations

from rkbench import counts

CELL_BYTES = 1                  # one table code
ROW_PARAM_BYTES = 28            # a user's scales, offsets and slack


def step1(n: int, d: int, tau: int, nb: int, table_bytes: int
          ) -> tuple[int, int]:
    """(bytes, f32 operations) of one K5 launch over nb queries: the int8
    rows and their per-user vectors read once, no thresholds searched
    (closed form), the table sectors the lookups touch, Q and ‖q‖₁, and
    12·n·nb bytes of bounds written."""
    nbytes = (n * d + ROW_PARAM_BYTES * n + table_bytes + 4 * (nb * d + nb)
              + 12 * n * nb)
    return nbytes, 2 * n * d * nb + 20 * n * nb


def query(n: int, d: int, tau: int, nb: int, k: int, table_bytes: int
          ) -> tuple[int, int]:
    """(bytes, f32 operations) of a query batch, whatever implements it:
    each input read once (the int8 rows with their per-user vectors, the
    queries, the table sectors the lookups touch) and each answer written
    once; no intermediate. The operations are the score product's."""
    nbytes = (n * d + ROW_PARAM_BYTES * n + 4 * nb * d + table_bytes
              + counts.ANSWER_BYTES * nb * k)
    return nbytes, 2 * n * d * nb
