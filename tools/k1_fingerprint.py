"""Fingerprint the float32 K1 instances of a checkout on the card, one line.

    python tools/k1_fingerprint.py TAG

Run from the root of a checkout: it imports that checkout's
feedback_gnn_tpu_torch, builds its kernels and prints "K1 TAG {...}" with
nvcc's seconds and the first 16 hex digits of SHA-256 digests of

* "out": K1's float32 marginals (the three stacked) at the main path's,
  the bench's and the rescue's shapes, through ``bp4_qc_marginals`` on the
  inputs chip_smoke.py's k1_timing phase makes (``random_inputs``, seed 2),
  and of every float32 instance (CN rule, phi form, degree pair, the
  generic (0, 0) among them) on [[882,24]] or GB-48 at B=256 x 12, factor
  0.9, seed 3;
* "sass": each float32 instance's SASS (cuobjdump -sass, the instruction
  text without addresses), keyed by CN rule, phi form, DC and DV.

Two checkouts run in one chip call, parent and change, show whether a
change left float32 K1's bits and its compiled code as they were.  Imports
no JAX.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())  # the checkout this runs from, not tools/
from feedback_gnn_tpu_torch import _build  # noqa: E402
from feedback_gnn_tpu_torch import codes as tc  # noqa: E402
from feedback_gnn_tpu_torch.decoders import bp4_qc  # noqa: E402

SHAPES = [("n882", 256, 64, None), ("n882", 256, 16, None), ("n1270", 20480, 12, None),
          ("n1270", 3072, 64, None), ("n1270", 1024, 16, None), ("n882", 512, 64, "tf"),
          ("n882", 512, 16, "accurate")]
CASES = [("boxplus-phi", None), ("boxplus-phi", "tf"), ("boxplus-phi", "accurate"), ("boxplus", None),
         ("minsum", None)]
K1_NAME = re.compile(r"bp4_qc_kernelI((?:Li-?\d+E)+)E")


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def out_digest(out) -> str:
    torch.cuda.synchronize()
    return digest(torch.stack(out).cpu().numpy().tobytes())


def random_inputs(qc, batch, seed):
    """chip_smoke.py's random_inputs on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    llr = torch.randn((3, qc.n, batch), generator=g, device="cuda") * 2.0
    sx = torch.randint(0, 2, (qc.qx.mb * qc.l, batch), generator=g, device="cuda").float()
    sz = torch.randint(0, 2, (qc.qz.mb * qc.l, batch), generator=g, device="cuda").float()
    return llr, sx, sz


def sass_digests(library):
    """{"cn,phi,dc,dv": digest} of the float32 K1 instances' SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300).stdout
    found = {}
    for section in re.split(r"\n\s*Function : ", dump)[1:]:
        m = K1_NAME.search(section.split("\n", 1)[0])
        if not m:
            continue
        args = [int(v) for v in re.findall(r"Li(-?\d+)E", m.group(1))]
        if len(args) == 5 and args[4] != 0:  # the bfloat16 carry's instances
            continue
        code = "\n".join(re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", section))
        found[",".join(map(str, args[:4]))] = digest(code.encode())
    return found


def main():
    tag = sys.argv[1]
    t0 = time.perf_counter()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    qcs = {"n882": tc.qc_pair_from_code(tc.ghp_882_24()), "n1270": tc.qc_pair_from_code(tc.ghp_1270_28()),
           "gb48": tc.qc_pair_from_code(tc.create_generalized_bicycle_codes(24, [0, 2, 8, 15],
                                                                            [0, 2, 12, 17]))}
    outs = {}
    for nm, batch, iters, phi in SHAPES:
        llr, sx, sz = random_inputs(qcs[nm], batch, 2)
        out = bp4_qc.bp4_qc_marginals(qcs[nm], llr, sx, sz, iters, phi_impl=phi)
        outs[f"{nm} B={batch} x{iters} phi={phi}"] = out_digest(out)
    for nm, instance in [("n882", None), ("gb48", None), ("n882", (0, 0))]:
        qc = qcs[nm]
        plan = bp4_qc._launch_plan(qc, 256, instance=instance)
        llr, sx, sz = random_inputs(qc, 256, 3)
        for cn_type, phi in CASES:
            out = bp4_qc._launch_kernel(qc, llr, sx, sz, 12, cn_type, 0.9, phi, plan)
            outs[f"{nm} {plan.instance} {cn_type} phi={phi}"] = out_digest(out)
    print(f"K1 {tag} " + json.dumps({"build_s": _build.build_info["seconds"], "load_s": build_s,
                                     "out": outs, "sass": sass_digests(_build.build_info["library"])}),
          flush=True)


if __name__ == "__main__":
    main()
