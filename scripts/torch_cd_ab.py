"""Same-call A/B of the coordinate-descent kernel against another checkout's.

    python3 scripts/torch_cd_ab.py
    python3 scripts/torch_cd_ab.py --repo DIR [--repo DIR2 ...] [--delay D ...]

Captures the kernel's inputs at the three shapes the LASSO rows give it,
as ``chip_smoke.py``'s ``cd_rows`` does (``cd_inputs``: Usual LASSO's
path, 11 fits × p 22 × 100 λs; Belloni's two CV-LASSOs, 22 × 462 × 100;
the binomial LASSO's first IRLS launch, 11 × 21 × 1), and times this
checkout's ``ops/lasso.py::cd_path`` on them with ``chip_smoke.py``'s
``device_ms`` (calls captured in a CUDA graph and replayed). Each
``--repo DIR`` (an earlier commit unpacked with ``git archive`` under
``build/``) has its ``csrc/lasso.cu`` built with the same ``nvcc`` flags
into ``build/cd_ab/`` and its C entry ``ate_cd_path`` called on the same
tensors, timed in turns with this checkout's (new, old, old, new);
``--delay D`` does the same for a copy of this checkout's source with
the kernel's delay d set to D (how d was chosen). Each
row gives both device times, ns per chain update (the longest fit's
sweeps × p, from each kernel's own sweep counts), max |Δβ| between the
two and the share of equal sweep counts. Prints one JSON line per shape
and checkout, with the card's name and power limit. It needs a card and
imports no JAX. A development tool: ``chip_smoke.py`` does not run it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SRC = os.path.join("ate_replication_causalml_torch", "csrc", "lasso.cu")
OUT = os.path.join(ROOT, "build", "cd_ab")

from ate_replication_causalml_torch.kernels import build  # noqa: E402
from ate_replication_causalml_torch.ops import lasso  # noqa: E402


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module, for its helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_smoke = _chip_smoke()


def _source_so(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(OUT, f"lasso-{digest}.so")


def delay_variant(d: int) -> str:
    """A copy of this checkout's ``csrc/lasso.cu`` with the delay d set to
    ``d``, as a checkout under ``build/cd_ab/``: its directory."""
    with open(os.path.join(ROOT, SRC)) as f:
        text = f.read()
    line = next(ln for ln in text.splitlines() if ln.startswith("constexpr int kDelay = "))
    repo = os.path.join(OUT, f"delay-{d}")
    path = os.path.join(repo, SRC)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:  # graftlint: disable=JGL005 — tmp half of a tmp+os.replace atomic write; the export helpers import the JAX package
        f.write(text.replace(line, f"constexpr int kDelay = {d};"))
    os.replace(path + ".tmp", path)
    return repo


def other_cd_paths(repos: list) -> list:
    """Each checkout's ``csrc/lasso.cu`` built into ``build/cd_ab/`` (one
    ``nvcc`` each, all started together) and bound: for each, a function
    with ``cd_path``'s arguments that launches its kernel."""
    os.makedirs(OUT, exist_ok=True)
    srcs = [os.path.join(repo, SRC) for repo in repos]
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", _source_so(src), src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src in dict.fromkeys(srcs) if not os.path.isfile(_source_so(src))]
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"torch_cd_ab: nvcc failed on {proc.args[-1]}:\n{log}")
    return [_bind(src) for src in srcs]


def _bind(src: str):
    fn = ctypes.CDLL(_source_so(src)).ate_cd_path
    fn.argtypes = build.KERNELS["cd_path"][2]
    fn.restype = ctypes.c_int

    def run(gram, xty, pf, lams, beta0, alpha, thresh, max_sweeps=lasso.MAX_SWEEPS):
        n_fits, p, _ = gram.shape
        betas = torch.empty((n_fits, lams.shape[1], p), dtype=gram.dtype, device=gram.device)
        sweeps = torch.empty(lams.shape, dtype=torch.int32, device=gram.device)
        code = fn(gram.data_ptr(), xty.data_ptr(), pf.data_ptr(), lams.data_ptr(),
                  None if beta0 is None else beta0.data_ptr(), n_fits, p, lams.shape[1],
                  float(alpha), float(1.0 - alpha), float(thresh), int(max_sweeps),
                  int(gram.dtype == torch.float64), betas.data_ptr(), sweeps.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{src}: ate_cd_path returned {code}")
        return betas, sweeps

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", action="append", default=[],
                    help="another checkout whose csrc/lasso.cu to time beside this one's")
    ap.add_argument("--delay", action="append", type=int, default=[],
                    help="time this checkout's kernel with the delay d set to this value too "
                         "(a multiple of 4, at least 8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_cd_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    repos = [os.path.abspath(r) for r in args.repo] + [delay_variant(d) for d in args.delay]
    others = list(zip(repos, other_cd_paths(repos)))
    _, frame_mod = _smoke.notebook_frames("cuda")
    for name, cd_args, _ in _smoke.cd_inputs(frame_mod):
        gram, p = cd_args[0], cd_args[0].shape[1]
        big = name == "belloni"
        calls, reps = (1, 3) if big else (10, 10)

        def timed(fn):
            betas, sweeps = fn(*cd_args)
            chain = int(sweeps.sum(dim=1).max()) * p
            return betas, sweeps, chain, lambda: _smoke.device_ms(lambda: fn(*cd_args), calls, reps)

        new_b, new_s, new_chain, new_ms = timed(lasso.cd_path)
        row = {"case": name, "B": gram.shape[0], "p": p, "L": cd_args[3].shape[1],
               "delay": lasso.cd_delay(), "new_chain_updates": new_chain}
        if not others:
            ms = new_ms()
            print(json.dumps({**row, "new_ms": ms, "new_ns_per_update": ms * 1e6 / new_chain,
                              "nvidia_smi": smi}), flush=True)
        for repo, fn in others:
            old_b, old_s, old_chain, old_ms = timed(fn)
            turns = [new_ms(), old_ms(), old_ms(), new_ms()]   # new, old, old, new
            new = [turns[0], turns[3]]
            old = [turns[1], turns[2]]
            print(json.dumps({
                **row, "repo": repo, "old_chain_updates": old_chain,
                "new_ms": new, "old_ms": old,
                "new_ns_per_update": [t * 1e6 / new_chain for t in new],
                "old_ns_per_update": [t * 1e6 / old_chain for t in old],
                "speedup": (old[0] + old[1]) / (new[0] + new[1]),
                "max_abs_diff": float((new_b - old_b).abs().max()),
                "sweeps_equal": float((new_s == old_s).double().mean()),
                "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
