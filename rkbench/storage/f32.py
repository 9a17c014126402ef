"""Least bytes and operations of a query batch and of its step 1 (K1) with
the users, thresholds and table at f32. The step-1 count is a frozen copy
of `chip_smoke.py`'s K1 count of its phase 5 (`k1_bytes`) as of commit
0ea130a."""
from __future__ import annotations

import math

from rkbench import counts

CELL_BYTES = 4                  # one table value


def step1(n: int, d: int, tau: int, nb: int, table_bytes: int
          ) -> tuple[int, int]:
    """(bytes, f32 operations) of one K1 launch over nb queries: U and Q
    read once, per user a search of its thresholds row and the table
    sectors the lookups touch, and 12·n·nb bytes of bounds written."""
    nbytes = (4 * (n * d + nb * d) + n * counts.search_bytes(4 * tau, nb)
              + table_bytes + 12 * n * nb)
    return nbytes, 2 * n * d * nb + n * nb * math.ceil(math.log2(tau))


def query(n: int, d: int, tau: int, nb: int, k: int, table_bytes: int
          ) -> tuple[int, int]:
    """(bytes, f32 operations) of a query batch, whatever implements it:
    each input read once (the users, the queries, the thresholds
    searched, the table sectors the lookups touch) and each answer
    written once (nb·k ids and estimates); no intermediate. The
    operations are the score product's."""
    nbytes = (4 * n * d + n * counts.search_bytes(4 * tau, nb) + 4 * nb * d
              + table_bytes + counts.ANSWER_BYTES * nb * k)
    return nbytes, 2 * n * d * nb
