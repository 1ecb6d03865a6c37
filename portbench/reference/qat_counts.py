"""Operations and bytes of a QAT step, whatever implements it: a training
step of ``counts.py`` (forward, backward, projection, the model's Adam, the
loss) plus the fake quantizers and the grids' Adams. Float32 operations per
active row:

- forward (``QUANT_FWD``): LSQ on xy (2 values), the off-diagonal (1) and
  the colours (3): a subtract, a divide, the clip's two compares, the round,
  a multiply-add (``LSQ`` = 7 each); the log quantizer on the two variances:
  the absolute value, the add of its epsilon, the log, a subtract, a divide,
  the two compares, the round, a multiply-add, the exp (``LOG`` = 11 each);
  the log grid's min and max over them (``MINMAX`` = 2 each);
- backward (``QUANT_BWD``): per LSQ value the straight-through gradient to
  the value (the clip's mask and the two scale factors: 3) and the
  gradients to its channel's scale and beta with their sums over the rows
  (``LSQ_BWD`` = 7); per variance the exp's and the log's derivatives and
  the chain through the grid (``LOG_BWD`` = 6);
- the grids' Adams: 12 values (xy 4, the off-diagonal 2, colour 6) at
  ``counts.ADAM`` each, once a step.

Bytes: per active row the 8 parameters read and their 8 fake-quantized
values written, forward and backward. The best snapshot's selects are moves,
not operations, and are not counted.
"""

from __future__ import annotations

from . import counts as C

LSQ, LOG, MINMAX = 7, 11, 2
LSQ_BWD, LOG_BWD = 7, 6
LSQ_VALUES, LOG_VALUES = 6, 2
QUANT_FWD = LSQ_VALUES * LSQ + LOG_VALUES * (LOG + MINMAX)
QUANT_BWD = LSQ_VALUES * LSQ_BWD + LOG_VALUES * LOG_BWD
GRID_VALUES = 12


def step(c: C.Pairs, active_rows: int) -> tuple[int, int]:
    """(operations, bytes) of one QAT step."""
    ops, nbytes = C.step(c, active_rows)
    ops += active_rows * (QUANT_FWD + QUANT_BWD) + GRID_VALUES * C.ADAM
    nbytes += active_rows * 2 * 2 * C.PARAMS * C.F32
    return ops, nbytes
