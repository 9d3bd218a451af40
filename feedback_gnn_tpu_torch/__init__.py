"""feedback_gnn_tpu_torch — the PyTorch/CUDA port of feedback_gnn_tpu.

Tanner-graph message-passing decoding of quantum LDPC codes on an NVIDIA
Hopper GPU: CSS code construction, Pauli channels, quaternary syndrome BP
(the fused quasi-cyclic BP4 decode is a hand-written CUDA kernel,
``csrc/bp4_qc.cu``) and the feedback-GNN sandwich cascade.

Plain tensor code is PyTorch; the package never imports JAX nor the JAX
package ``feedback_gnn_tpu``, whose shipped data files (trained weights,
check matrices) it reads in place by path.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

import os

import torch

__version__ = "0.1.0"

# root of the repository checkout: the JAX package's data files are read
# from here by path
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _init_cpu_vml():
    """Initialise MKL's vector math on this thread before any parallel call.

    On the CPU, PyTorch evaluates float32 ``exp``, ``log`` and ``tanh``
    through MKL's VML (``vmsExp``, ``vmsLn``, ``vmsTanh``), each of its
    OpenMP threads on its own chunk.  VML sets itself up at its first call
    in the process; when that first call comes from several threads at
    once, one of them now and then computes its chunk by another path
    (errors up to ~1e-4 on exp's values in (0, 1]) on that call alone, so
    the same input gave other bits on the first call than on later ones.
    A one-element call runs on the calling thread alone and sets VML up
    before any parallel call can race it."""
    one = torch.ones(1)
    for op in (torch.exp, torch.log, torch.tanh):
        op(one)


_init_cpu_vml()


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU.  Raises when no card is
    found and the CPU was not asked for — there is no silent fallback.

    On the card, float32 matmuls are pinned to full float32 (TF32 off):
    the feedback GNN's dense layers would otherwise round their inputs to
    10 mantissa bits and drift from the JAX reference.  The 0/1 syndrome
    matmuls would stay exact either way (TF32 accumulates in float32)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
