"""Batched order-0 ordered-statistics decoding (OSD-0).

The port of ``feedback_gnn_tpu/decoders/osd.py``: sort the qubits by
reliability, append the syndrome column, eliminate over GF(2) with
first-one pivoting per row, scatter the solution back through the inverse
sort.

The elimination is integer only, so its solutions equal the JAX package's
bit for bit on the same inputs: the sort is stable (as ``jnp.argsort``;
LLR ties are common, and -0.0 ties with +0.0) and each row's pivot is its
leftmost one.

On a card ``osd0_decode`` is one hand-written kernel (``csrc/osd0.cu``):
a block a sample sorts the reliabilities, builds the sample's bit-packed
table in shared memory from the basis packed as column bit-vectors
(``pack_columns``), eliminates forward and back-substitutes; no table
touches device memory.  It takes any basis whose rows fit in 64 words of
32 columns and whose block fits in 227 KB of shared memory
(``shared_bytes``: 53 KB on [[882,24]], 106 KB on [[1270,28]]) and raises
ValueError for any other CUDA call.  CPU tensors take
``osd0_decode_plain``, a rank-step Gauss-Jordan loop over a uint8 table
([B, rank, n+1] = [B, 429, 883], 379 KB a sample on [[882,24]], a quarter
of the JAX package's int32 bytes), which is also the kernel's oracle.  The
counter ``osd.launches`` (``obs``; always on) counts the calls on the card,
keyed by path (``"kernel"``, or ``"plain"`` where the plain version itself
is called with card tensors) and batch.

``osd0_on_flagged`` runs OSD on the BP-flagged samples gathered flagged-first
(``compact.py``) into a sub-batch, for both sides in ``bp_osd_correct`` and one
in BP2 + OSD-0; flagged samples beyond the capacity keep their BP estimate.

Spans (obs.py): ``osd.flag`` (the flag test, the binary reliabilities and
the pivot-reduced syndromes), ``osd.compact`` (the flagged-first gather
and the scatter back) and ``osd.eliminate`` (each ``osd0_decode`` call,
attribute ``side``: "x" or "z", "bsc" for BP2 + OSD-0's one side).
Counters while tracing: ``osd.flagged`` (flagged samples, summed on the
device) and ``osd.capacity`` (the samples OSD decodes: the sub-batch, or
the whole batch without a cap).
"""

from __future__ import annotations

import torch

from .. import obs
from ..ops.gf2mat import mod2_matmul
from .bp4 import quaternary_to_binary_llrs
from .compact import flagged_first, merge
from .graph_ops import pad_rows_to

__all__ = ["osd0_decode", "osd0_decode_plain", "pack_columns", "shared_bytes", "osd0_on_flagged",
           "bp_osd_correct"]

# benchmark/osd.py's recorder patches this name to capture each batch's
# sub-batch, so osd0_on_flagged calls the compaction through it
_flagged_first = flagged_first

SHARED_LIMIT = 232_448  # bytes of shared memory a block can have on sm_90 (227 KB)
MAX_WORDS = 64  # 32-bit words of a table row the kernel takes (two a lane)


def pack_columns(pcm: torch.Tensor) -> torch.Tensor:
    """[rank, n] 0/1 -> [n, ceil(rank / 32)] int32 on ``pcm``'s device: bit
    j of word g of column c is ``pcm[32 g + j, c]``, the kernel's view of
    the basis."""
    rank, n = pcm.shape
    groups = -(-rank // 32)
    bits = torch.nn.functional.pad((pcm != 0).T.to(torch.int32), (0, 32 * groups - rank))
    shifts = torch.arange(32, dtype=torch.int32, device=pcm.device)
    # distinct powers of two: the int32 sum is their OR, bit 31 included
    return (bits.view(n, groups, 32) << shifts).sum(dim=-1, dtype=torch.int32)


def shared_bytes(rank: int, n: int) -> int:
    """Shared memory of the kernel's block for a [rank, n] basis
    (csrc/osd0.cu, osd_shape): the table, rank rows at an odd stride of
    words (or the sort's 64-bit keys, a power of two of them at least n,
    where larger), the order and its inverse (uint16), the pivots (uint16),
    the packed syndrome and the solution."""
    words = (n + 32) // 32
    keys = 1 << max(n - 1, 0).bit_length()
    region = max(4 * rank * (words | 1), 8 * keys)
    synw = -(-(region + 4 * n + 2 * rank) // 4) * 4
    return synw + 4 * -(-rank // 32) + 4 * words


def _check_shape(rank: int, n: int):
    """Raise ValueError unless the kernel takes a [rank, n] basis."""
    words = (n + 32) // 32
    if rank < 1 or n < 1 or words > MAX_WORDS:
        raise ValueError(f"a [{rank}, {n}] basis: the OSD-0 kernel takes rows of at most {MAX_WORDS} words "
                         f"of 32 columns, syndrome included (n <= {32 * MAX_WORDS - 1})")
    need = shared_bytes(rank, n)
    if need > SHARED_LIMIT:
        raise ValueError(f"a [{rank}, {n}] basis needs {need} bytes of shared memory a block: the OSD-0 kernel "
                         f"has {SHARED_LIMIT}")


def _launch_osd0(llr, pcm, syndrome):
    """OSD-0 as one kernel (csrc/osd0.cu) on the current stream: e_hat
    [B, n] int32.  Raises ValueError for a call the kernel cannot take."""
    from .._build import load_kernels

    bsz, n = llr.shape
    dev = llr.device
    basis = torch.as_tensor(pcm, device=dev)
    syn = torch.as_tensor(syndrome, device=dev)
    if llr.dtype != torch.float32:
        raise ValueError(f"reliabilities of dtype {llr.dtype}: the OSD-0 kernel takes float32")
    if basis.dim() != 2 or basis.shape[1] != n:
        raise ValueError(f"a basis of shape {tuple(basis.shape)} for {n} columns")
    rank = basis.shape[0]
    if tuple(syn.shape) != (rank, bsz):
        raise ValueError(f"syndromes of shape {tuple(syn.shape)}: the basis and batch give ({rank}, {bsz})")
    _check_shape(rank, n)
    out = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    cols = pack_columns(basis)
    llr, syn = llr.contiguous(), syn.to(torch.int32).contiguous()
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fgt_osd0_launch(llr.data_ptr(), cols.data_ptr(), cols.shape[1], syn.data_ptr(), out.data_ptr(),
                                  bsz, n, rank, stream)
    if err != 0:
        raise RuntimeError(f"OSD-0 kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")
    obs.count("osd.launches", key=("kernel", bsz))
    return out


def osd0_decode(llr, pcm, syndrome):
    """OSD-0 decode on ``llr``'s device: the kernel for CUDA tensors, the
    plain version for CPU tensors (the module docstring).

    Args:
      llr: [B, n] float32 reliabilities; the columns are taken in ascending
        order (the least reliable, most likely flipped, first).
      pcm: [rank, n] 0/1, a full-rank parity-check basis (tensor or array).
      syndrome: [rank, B] 0/1, the pivot-reduced syndromes.

    Returns e_hat [B, n] int32.
    """
    if llr.is_cuda:
        return _launch_osd0(llr, pcm, syndrome)
    return osd0_decode_plain(llr, pcm, syndrome)


def osd0_decode_plain(llr, pcm, syndrome):
    """``osd0_decode`` in plain PyTorch on any device, one Python step a
    rank row over a [B, rank, n+1] uint8 table: the CPU's path and the
    kernel's oracle.  Counts ``osd.launches`` ("plain") for card tensors."""
    bsz, n = llr.shape
    dev = llr.device
    if llr.is_cuda:
        obs.count("osd.launches", key=("plain", bsz))
    pcm = torch.as_tensor(pcm, device=dev).to(torch.uint8)
    rank = pcm.shape[0]

    sort_order = torch.argsort(llr, dim=-1, stable=True)  # [B, n]
    inv_sort = torch.argsort(sort_order, dim=-1)  # a permutation: no ties

    # permuted pcm per sample + syndrome column: [B, rank, n+1]
    tab = torch.empty((bsz, rank, n + 1), dtype=torch.uint8, device=dev)
    tab[:, :, :n] = pcm.T[sort_order].transpose(1, 2)
    tab[:, :, n] = torch.as_tensor(syndrome, device=dev).T.to(torch.uint8)

    pivots = torch.empty((bsz, rank), dtype=torch.int64, device=dev)
    samples = torch.arange(bsz, device=dev)
    for row in range(rank):
        current = tab[:, row, :].clone()  # [B, n+1]
        idx_p = torch.argmax(current, dim=-1)  # leftmost 1 of the row
        pivots[:, row] = idx_p
        c = tab[samples, :, idx_p]  # [B, rank]: the pivot column
        c[:, row] = 0  # the pivot row itself stays
        tab ^= c[:, :, None] & current[:, None, :]

    sol = tab[:, :, n].to(torch.int32)  # [B, rank]
    # a full-rank basis gives every row its own pivot column
    e_sorted = torch.zeros((bsz, n), dtype=torch.int32, device=dev).scatter_(1, pivots, sol)
    return e_sorted.gather(1, inv_sort)


def osd0_on_flagged(flagged, compact_cap: int | None, sides):
    """OSD-0 on the ``flagged`` [B] samples gathered flagged-first into a
    sub-batch of ``compact_cap`` (None: the batch), one ``osd0_decode`` a
    side in order.  A side is (name, estimate [rows, B] int32, reliabilities
    [n, B], basis [rank, n], pivot-reduced syndrome [rank, B]).  Returns the
    sides' estimates with OSD's solutions merged in where the sub-batch is
    flagged, and the 0-d int32 count of flagged samples it leaves out."""
    cap = flagged.shape[0] if compact_cap is None else min(flagged.shape[0], int(compact_cap))
    if obs.on():
        obs.count_device("osd.flagged", flagged)
        obs.count("osd.capacity", cap)
    with obs.span("osd.compact"):
        idx, valid = _flagged_first(flagged, cap)
        overflow = flagged.sum(dtype=torch.int32) - valid.sum(dtype=torch.int32)
    out = []
    for side, estimate, llr, basis, syndrome in sides:
        with obs.span("osd.compact"):
            llr_s, syn_s = llr.T[idx], syndrome[:, idx]
        with obs.span("osd.eliminate", side=side):
            sol = osd0_decode(llr_s, basis, syn_s)
        with obs.span("osd.compact"):
            out.append(merge(estimate, idx, pad_rows_to(sol.T, estimate.shape[0]), valid))
    return out, overflow


def bp_osd_correct(graph, bp_result, noise_x, noise_z, pivot_hx, pivot_hz, hx_basis, hz_basis,
                   compact_cap: int | None = None):
    """BP4 + OSD-0 correction step: OSD replaces the BP estimate of every
    BP-flagged sample.

    Args:
      graph: a ``QuantumGraph`` of tensors.
      bp_result: ``BP4Result`` of the decode.
      noise_x / noise_z: [n(,pad), B] 0/1 true errors.
      pivot_hx / pivot_hz: row indices of the full-rank bases.
      hx_basis / hz_basis: [rank, n] full-rank PCMs.

    Returns (x_hat, z_hat, flagged [B] bool, overflow 0-d int), x_hat and
    z_hat int32 [n_pad, B]; the overflow counts flagged samples beyond
    ``compact_cap`` (0 without a cap).
    """
    hx, hz, n = graph.hx, graph.hz, graph.n
    noise_x = pad_rows_to(noise_x.to(torch.int32), graph.n_pad)
    noise_z = pad_rows_to(noise_z.to(torch.int32), graph.n_pad)
    dev = noise_x.device
    with obs.span("osd.flag"):
        # flagged = BP failed to reproduce the syndrome
        x_diff = noise_x ^ bp_result.x_hat
        z_diff = noise_z ^ bp_result.z_hat
        flagged = (mod2_matmul(hz, x_diff) != 0).any(dim=0) | (mod2_matmul(hx, z_diff) != 0).any(dim=0)

        # binary reliabilities from the quaternary marginals, true qubit rows
        osd_llrx, osd_llrz = quaternary_to_binary_llrs(
            bp_result.llrx[:n], bp_result.llry[:n], bp_result.llrz[:n])

        # pivot-reduced syndromes of the true noise
        red_sx = mod2_matmul(hx, noise_z)[torch.as_tensor(pivot_hx, device=dev)]
        red_sz = mod2_matmul(hz, noise_x)[torch.as_tensor(pivot_hz, device=dev)]
    (z_hat, x_hat), overflow = osd0_on_flagged(flagged, compact_cap, [
        ("z", bp_result.z_hat, osd_llrz, hx_basis, red_sx), ("x", bp_result.x_hat, osd_llrx, hz_basis, red_sz)])
    return x_hat, z_hat, flagged, overflow
