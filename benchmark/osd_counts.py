"""Least times on an H100 of the BP4 + OSD-0 step's work beside K1's
(counts.py): OSD-0's elimination and the GF(2) products.

OSD-0's elimination is integer work.  Its least form is forward
elimination on bit-packed rows of 32-bit words held on the chip (in
registers or shared memory): at each pivot, a bit test of each row below,
and a masked XOR (one LOP3) of each word from the pivot's word to the
syndrome's of each row below that holds a one in the pivot column.  How
many rows hold one depends on the sample's column order, so the count
comes from the reference's elimination of the checked batches' flagged
samples (reference/osd.py ``osd0``), as a mean per sample over both
sides.  Its least time is those operations at the H100's 32-bit integer
issue rate, 64 a clock on each SM.  The bytes each sample moves through
HBM (its reliabilities in, its solution out, a few KB) take a small
fraction of that and are left out.  Only the flagged samples decoded
count, not a sub-batch's padding, so the bound is the same work whatever
implements it.
"""

from __future__ import annotations

from . import counts

__all__ = ["H100_SMS", "H100_CLOCK_HZ", "INT_OPS_PER_CLK_SM", "osd_bound_ms", "gf2_bound_ms"]

H100_SMS = 132  # H100 SXM
H100_CLOCK_HZ = 1.98e9  # boost clock
INT_OPS_PER_CLK_SM = 64  # 32-bit integer and logical operations a clock an SM (compute capability 9.0)


def osd_bound_ms(decoded, ops_per_sample):
    """Least time of OSD-0 on ``decoded`` samples of ``ops_per_sample``
    32-bit integer operations each (both sides), in ms."""
    return 1e3 * decoded * ops_per_sample / (H100_SMS * INT_OPS_PER_CLK_SM * H100_CLOCK_HZ)


def gf2_bound_ms(ops):
    """Least time of GF(2) products of ``ops`` operations (counts.gf2_ops)
    at the float32 peak that cascade_mfu charges them at, in ms."""
    return 1e3 * ops / counts.H100_F32_OPS
