"""Stage-timed 1M-row causal-forest fit on the card (torch port).

    python3 scripts/torch_stage_time_1m.py [--rows 1000000] [--trees 2000] [--once]
                                           [--trace-out PATH] [--predict] [--aipw]
                                           [--device cuda|cpu]

The port's twin of ``scripts/stage_time_1m.py``: the same data (the
panel of ``bench.py --forest``, :func:`make`) and the same calls, each
stage synchronized and timed on its own under the same labels:
nuisance-Y fit (``fit_y``: 500 trees of depth 9), its OOB mean
(``oob_y``), nuisance-W fit and OOB mean (``fit_w``, ``oob_w``), the
honest causal grow on the residuals (``grow``: ``--trees`` trees of depth
8) and the CATE + AIPW step (``cate_aipw``). Each nuisance forest is
released after its OOB stage, so no two fits' (T, n) tensors are held at
once. The first pass builds the kernels; the second (skipped by
``--once``) is steady. Beside each stage's wall it prints the peak of
``torch.cuda.max_memory_allocated`` over the stage (reset at its start)
and the kernel launches the stage made.

Two more stages come behind flags, on the last pass's forest:

* ``--predict``: ``bench.py``'s cached predict with variance: the (T, n)
  leaf index (``compute_leaf_index``), then ``predict_cate(oob=True,
  leaf_index=...)``, one first call and two steady calls;
* ``--aipw``: ``bench.py``'s north star on :func:`make_panel` at
  ``--rows``: the logit outcome model, the logit propensity, the AIPW τ
  and the 10,000-replicate Poisson bootstrap SE (chunks of 25), one first
  call and three timed calls; beside the bootstrap SE the plug-in SE of
  the same combination, ``sd(est1 + est2) / sqrt(n)``.

The panels are drawn with the port's threefry (``ops/random.py``) on the
chosen device; on the card both are also drawn on the CPU and the rows
that differ are counted (the sigmoids are taken in float64 and rounded
once, so the expected count is 0). Timing runs through the port's
``StageTimer`` (each stage a span of the event log, inside one
``bench_leg`` span a pass), exported as a Perfetto trace
(``--trace-out``, default ``build/torch_stage_time_trace.json``; '' turns
it off). Prints ``#`` lines and, last, one JSON object of every figure;
writes no record file. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from ate_replication_causalml_torch import observability as obs  # noqa: E402
from ate_replication_causalml_torch import resolve_device  # noqa: E402
from ate_replication_causalml_torch.data.frame import CausalFrame  # noqa: E402
from ate_replication_causalml_torch.estimators.aipw import _outcome_model_mu, aipw_tau  # noqa: E402
from ate_replication_causalml_torch.models.causal_forest import (  # noqa: E402
    FittedCausalForest,
    average_treatment_effect,
    compute_leaf_index,
    grow_causal_forest,
    predict_cate,
)
from ate_replication_causalml_torch.models.forest import (  # noqa: E402
    fit_forest_regressor,
    forest_oob_mean,
)
from ate_replication_causalml_torch.ops import bootstrap as bt  # noqa: E402
from ate_replication_causalml_torch.ops import hist, pack, tree  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402
from ate_replication_causalml_torch.ops.glm import logistic_glm  # noqa: E402
from ate_replication_causalml_torch.ops.linalg import add_intercept  # noqa: E402
from ate_replication_causalml_torch.utils.profiling import StageTimer  # noqa: E402

P = 21                      # covariates, the GGL shape of bench.py's panels
NUISANCE_TREES = 500
NUISANCE_DEPTH = 9
CAUSAL_DEPTH = 8
N_BOOT = 10_000             # bench.py's N_BOOT and CHUNK
BOOT_CHUNK = 25
TRUE_ATE = 1.5              # E[τ(x)] = 1 + P(x₀ > 0) of make()'s panel
DEFAULT_TRACE = os.path.join(_REPO_ROOT, "build", "torch_stage_time_trace.json")

# Each kernel's launch counter: (wrapper, attribute), as the wrappers count.
KERNEL_COUNTERS = {
    "hist": (hist.bin_histogram_batched, "launches"),
    "hist_partition": (hist.bin_histogram_batched, "partition_launches"),
    "hist_partition_packed": (hist.bin_histogram_batched, "packed_launches"),
    "hist_shared": (hist.bin_histogram_shared, "launches"),
    "hist_partition_shared": (hist.bin_histogram_shared, "partition_launches"),
    "hist_partition_shared_packed": (hist.bin_histogram_shared, "packed_launches"),
    "node_sums": (hist.node_sums, "launches"),
    "node_sums_shared": (hist.node_sums_shared, "launches"),
    "route": (tree.route_bits, "launches"),
    "route_advance": (tree.route_advance, "launches"),
    "traverse": (tree.traverse, "launches"),
    "leaf_record": (tree.leaf_record, "launches"),
    "lookup": (tree.table_lookup, "launches"),
    "pack_codes": (pack.pack_codes, "launches"),
}


def _sigmoid(t: torch.Tensor) -> torch.Tensor:
    """σ in float64, rounded once to float32: the same bits on the card
    and on the CPU (PyTorch's float32 sigmoid is each device's own
    approximation). ``jax.nn.sigmoid`` on the CPU rounds otherwise too,
    by an ulp; a 0/1 draw ``u < σ`` then differs only where the uniform
    falls between the two roundings (about 1e-8 of the rows)."""
    return torch.sigmoid(t.to(torch.float64)).to(torch.float32)


def _panel_wy(x: torch.Tensor, kw: torch.Tensor, ky: torch.Tensor):
    logits_w = -1.6 + 0.3 * x[:, 0] - 0.2 * x[:, 1]
    w = (rnd.uniform(kw, (x.shape[0],)) < _sigmoid(logits_w)).to(torch.float32)
    logits_y = -0.5 + 0.8 * x[:, 2] + 0.4 * w
    y = (rnd.uniform(ky, (x.shape[0],)) < _sigmoid(logits_y)).to(torch.float32)
    return w, y


def _make_wy(x: torch.Tensor, kw: torch.Tensor, ky: torch.Tensor):
    n = x.shape[0]
    tau = 1.0 + (x[:, 0] > 0)
    w = (rnd.uniform(kw, (n,)) < _sigmoid(0.8 * x[:, 1])).to(torch.float32)
    y = 0.5 * x[:, 1] + tau * w + 0.5 * rnd.normal(ky, (n,))
    return w, y.to(torch.float32)


def make_panel(key: torch.Tensor, n: int):
    """``bench.py:75 make_panel``: 21 standard-normal covariates in the
    GGL shape, a randomized W (logit −1.6 + 0.3·x₀ − 0.2·x₁) and a binary
    Y (logit −0.5 + 0.8·x₂ + 0.4·W), drawn on ``key``'s device."""
    kx, kw, ky = rnd.split(key, 3).unbind(dim=0)
    x = rnd.normal(kx, (n, P))
    return (x, *_panel_wy(x, kw, ky))


def make(n: int, device=None) -> CausalFrame:
    """``scripts/stage_time_1m.py:47 make`` (``bench.py:181-187``): the
    same covariates as :func:`make_panel` at ``key(0)``, τ(x) = 1 +
    1[x₀ > 0] (mean 1.5), W ~ Bernoulli(σ(0.8·x₁)), Y = 0.5·x₁ + τ·W +
    0.5·ε."""
    kx, kw, ky = rnd.split(rnd.key(0, device=device), 3).unbind(dim=0)
    x = rnd.normal(kx, (n, P))
    w, y = _make_wy(x, kw, ky)
    return CausalFrame(x=x, w=w, y=y)


def differing_rows(got, want) -> int:
    """Rows of a panel (tensors (n, ...) each) that differ anywhere."""
    bad = None
    for a, b in zip(got, want):
        ne = a.cpu() != b.cpu()
        ne = ne.reshape(ne.shape[0], -1).any(dim=1)
        bad = ne if bad is None else bad | ne
    return int(bad.sum())


def draw_panels(n: int, device) -> dict:
    """Both panels at ``key(0)`` on ``device``, their shared covariates
    drawn once: ``x``, :func:`make_panel`'s ``panel_w`` / ``panel_y`` and
    :func:`make`'s ``make_w`` / ``make_y``."""
    kx, kw, ky = rnd.split(rnd.key(0, device=device), 3).unbind(dim=0)
    x = rnd.normal(kx, (n, P))
    (pw, py), (mw, my) = _panel_wy(x, kw, ky), _make_wy(x, kw, ky)
    return {"x": x, "panel_w": pw, "panel_y": py, "make_w": mw, "make_y": my}


def panel_differences(got: dict, want: dict) -> dict:
    """Rows of each panel that differ between two :func:`draw_panels`
    results (say the card's and the CPU port's)."""
    return {name: differing_rows([got[k] for k in ("x", f"{name}_w", f"{name}_y")],
                                 [want[k] for k in ("x", f"{name}_w", f"{name}_y")])
            for name in ("panel", "make")}


def launch_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in KERNEL_COUNTERS.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stages:
    """A :class:`StageTimer` whose stages also record the peak device
    memory over the stage (reset at its start; None on the CPU) and the
    kernel launches the stage made. Each stage ends with a sync, inside
    its span."""

    def __init__(self, device: torch.device):
        self.device = device
        self.timer = StageTimer()
        self.peak: dict = {}
        self.launches: dict = {}

    def run(self, name: str, fn):
        cuda = self.device.type == "cuda"
        sync(self.device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        before = launch_counts()
        with self.timer.stage(name):
            out = fn()
            sync(self.device)
        after = launch_counts()
        self.peak[name] = torch.cuda.max_memory_allocated(self.device) if cuda else None
        self.launches[name] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        return out

    def rows(self) -> dict:
        return {k: {"s": v, "peak_bytes": self.peak[k], "launches": self.launches[k]}
                for k, v in self.timer.seconds.items()}


def _gb(b) -> str:
    return "n/a" if b is None else f"{b / 2**30:.2f}GB"


def print_stages(label: str, rows: dict, extra: str = "") -> None:
    total = sum(r["s"] for r in rows.values())
    stages = " ".join(f"{k}={r['s']:.3f}s" for k, r in rows.items())
    print(f"# [{label}] total={total:.3f}s {stages}{extra}", flush=True)
    for k, r in rows.items():
        print(f"#   {label}.{k}: {r['s']:.4f}s peak={_gb(r['peak_bytes'])} "
              f"launches={r['launches']}", flush=True)


def run(frame: CausalFrame, n_trees: int, seed: int, label: str, *,
        nuisance_trees: int = NUISANCE_TREES):
    """One pass of the six stages on ``frame`` from ``key(seed)``, split
    as the JAX script splits it. Returns (the fitted forest, a record:
    each stage's seconds, peak bytes and launches; ATE and SE)."""
    dev = frame.device
    x, w, y = frame.x, frame.w, frame.y
    ky, kw_, kc = rnd.split(rnd.key(seed, device=dev), 3).unbind(dim=0)
    st = Stages(dev)
    fit = lambda target, k: fit_forest_regressor(x, target, k, n_trees=nuisance_trees,
                                                 depth=NUISANCE_DEPTH)
    with obs.span("bench_leg", leg=label, trees=n_trees):
        fy = st.run("fit_y", lambda: fit(y, ky))
        y_hat = st.run("oob_y", lambda: forest_oob_mean(fy, x))
        del fy
        fw = st.run("fit_w", lambda: fit(w, kw_))
        w_hat = st.run("oob_w", lambda: forest_oob_mean(fw, x))
        del fw
        forest = st.run("grow", lambda: grow_causal_forest(x, w - w_hat, y - y_hat, kc,
                                                           n_trees=n_trees,
                                                           depth=CAUSAL_DEPTH))
        fitted = FittedCausalForest(forest=forest, y_hat=y_hat, w_hat=w_hat, x=x, y=y, w=w)
        eff = st.run("cate_aipw", lambda: average_treatment_effect(fitted))
    rec = {"stages": st.rows(), "ate": float(eff.estimate), "se": float(eff.std_err)}
    print_stages(label, rec["stages"], f" ate={rec['ate']:.6f} se={rec['se']:.6f}")
    return fitted, rec


def run_predict(fitted: FittedCausalForest) -> dict:
    """``bench.py:116 bench_forest_predict``: the leaf-index cache, then
    three cached OOB predicts with variance (first, then two steady)."""
    dev = fitted.x.device
    n = fitted.x.shape[0]
    st = Stages(dev)
    li = st.run("leaf_index", lambda: compute_leaf_index(fitted.forest, fitted.x))
    preds = [st.run(f"predict_{i}", lambda: predict_cate(fitted.forest, fitted.x, oob=True,
                                                         leaf_index=li))
             for i in range(3)]
    rows = st.rows()
    pred = preds[-1]
    rec = {"stages": rows, "leaf_index_dtype": str(li.dtype),
           "leaf_index_bytes": li.numel() * li.element_size(),
           "first_s": rows["predict_0"]["s"],
           "steady_s": min(rows["predict_1"]["s"], rows["predict_2"]["s"]),
           "mean_cate": float(pred.cate.sum()) / n, "mean_var": float(pred.variance.sum()) / n}
    print_stages("predict", rows, f" steady={rec['steady_s']:.4f}s "
                 f"mean_cate={rec['mean_cate']:.6f} mean_var={rec['mean_var']:.8f}")
    return rec


def aipw_bootstrap(x, w, y, key, n_boot: int = N_BOOT, chunk: int | None = BOOT_CHUNK):
    """``bench.py``'s ``full_aipw_bootstrap``: the logit outcome model,
    the logit propensity, the AIPW τ (``compat="r"``) and the Poisson
    bootstrap SE in chunks of ``chunk`` (None: ``aipw_bootstrap_se``'s
    "auto", which takes the Poisson path above 100,000 rows with its
    chunk rule). Returns (τ, SE, plug-in SE): the plug-in SE is
    ``sd(est1 + est2) / sqrt(n)`` over the same five vectors, what a
    Poisson replicate's SD is to first order."""
    mu0, mu1 = _outcome_model_mu(x, w, y)
    p = logistic_glm(add_intercept(x), w).fitted
    tau = aipw_tau(w, y, p, mu0, mu1)
    if chunk is None:
        se = bt.aipw_bootstrap_se(w, y, p, mu0, mu1, key=key, n_boot=n_boot)
    else:
        se = bt.sd(bt.aipw_bootstrap_taus_poisson(w, y, p, mu0, mu1, key=key, n_boot=n_boot,
                                                  chunk=chunk))
    combo = bt._est1(w, y, p, mu0, mu1, 1.0) + (mu1 - mu0)
    plugin = torch.std(combo, correction=1) / math.sqrt(combo.shape[0])
    return tau, se, plugin


def run_aipw(n: int, device: torch.device, n_boot: int = N_BOOT) -> dict:
    """The AIPW north star at ``n`` rows: one first call (key 1), then
    three timed calls (keys 2-4), as ``bench.py`` runs it."""
    st = Stages(device)
    x, w, y = st.run("panel", lambda: make_panel(rnd.key(0, device=device), n))
    calls = []
    for i, seed in enumerate((1, 2, 3, 4)):
        k = rnd.key(seed, device=device)
        tau, se, plugin = st.run(f"aipw_{i}", lambda k=k: aipw_bootstrap(x, w, y, k, n_boot))
        calls.append((float(tau), float(se), float(plugin)))
    rows = st.rows()
    tau, se, plugin = calls[-1]
    rec = {"stages": rows, "n_boot": n_boot, "chunk": BOOT_CHUNK,
           "first_s": rows["aipw_0"]["s"],
           "steady_s": min(rows[f"aipw_{i}"]["s"] for i in (1, 2, 3)),
           "tau": tau, "boot_se": se, "plugin_se": plugin,
           "boot_se_by_call": [c[1] for c in calls]}
    print_stages("aipw", rows, f" steady={rec['steady_s']:.4f}s tau={tau:.6f} "
                 f"boot_se={se:.6f} plugin_se={plugin:.6f}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=2000)
    ap.add_argument("--once", action="store_true", help="skip the steady pass")
    ap.add_argument("--trace-out", default=DEFAULT_TRACE, help="Perfetto trace path ('' disables)")
    ap.add_argument("--predict", action="store_true",
                    help="the cached 1M-row predict with variance on the last pass's forest")
    ap.add_argument("--aipw", action="store_true",
                    help="the 10,000-replicate Poisson AIPW on make_panel at --rows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out: dict = {"rows": args.rows, "trees": args.trees, "nuisance_trees": NUISANCE_TREES,
                 "boot": N_BOOT, "device": str(dev),
                 "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(f"# device={out['device_name']} torch={torch.__version__} rows={args.rows} "
          f"trees={args.trees}", flush=True)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        diff = panel_differences(draw_panels(args.rows, dev), draw_panels(args.rows, "cpu"))
        out["panel_rows_differing_from_cpu"] = diff
        print(f"# panel rows differing from the CPU port's: {diff} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    frame = make(args.rows, dev)
    fitted, out["first"] = run(frame, args.trees, 1, "first", nuisance_trees=NUISANCE_TREES)
    if not args.once:
        fitted = None   # the first forest is released before the next fit
        fitted, out["steady"] = run(frame, args.trees, 2, "steady", nuisance_trees=NUISANCE_TREES)
    if args.predict:
        out["predict"] = run_predict(fitted)
    fitted = None
    if args.aipw:
        del frame
        out["aipw"] = run_aipw(args.rows, dev, n_boot=N_BOOT)
    if args.trace_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace_out)), exist_ok=True)
        path = obs.write_trace_json(args.trace_out, obs.build_trace(
            meta={"tool": "torch_stage_time_1m", "rows": args.rows, "trees": args.trees}))
        if path:
            print(f"# trace: {path} (ui.perfetto.dev)", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
