"""Batched estimator entry points of the scenario matrix.

Port of ``ate_replication_causalml_tpu/scenarios/batched.py``. A
Monte-Carlo matrix of thousands of (DGP × estimator × seed) cells runs
each scenario COLUMN through one batched function over its replicate
lanes:

* :func:`cell_fn` — one replicate, a pure function of ``(root_key,
  cell_id)``: fold in the data key, generate the draw
  (``scenarios/dgp.py``), derive the estimator's private key, estimate
  with the estimator's scalar ``fn``. This is the scalar replay.
* :func:`column_executable` — the column's callable over a width-W
  batch of cell ids: the lanes' draws in one :func:`~.dgp.generate`
  call and the estimator's ``batched`` form, the explicit counterpart
  of the JAX package's ``jit(vmap(cell_fn))``. ``torch.func.vmap``
  cannot carry these fits (the IRLS loop stops on a host read, the
  coordinate descent is a ctypes launch), so each vmapped estimator
  names a batched form: the GLM and OLS estimators' own cores, which
  take a (B, n, p) batch as well as one frame (``ops/glm.py::
  logistic_glm`` and ``ops/linalg.py::ols`` fit lane by lane), and the
  LASSO column's ``ops/lasso.py::cv_glmnet_lanes``.
  The callable is made once per :func:`column_cache_key` and shared;
  nothing is traced or compiled, so a column's "compile" is the
  ``scenario_column_compile_total`` tick of its first request, and the
  process's compile events are the kernel builds and graph captures
  (:func:`compile_event_count`), 0 after the first kernel launch.
* forest-class engines (``vmapped=False``) cannot batch a whole fit;
  the planner packs them at width 1 and each cell dispatches through the
  models' own machinery (``_est_aipw_rf``: ``rf_oob_propensity`` at 16
  trees of depth 4, the forest kernels on the card).

Batched against scalar: ``naive`` sums in
:func:`~..ops.linalg.fixed_sum`'s order in both forms (one lane
function), so the column is bit-identical to its replay on either
device (``vmap_collapse_exact``). The IRLS and OLS fits of the GLM
columns fit each lane on its own (``ops/linalg.py::over_lanes``): every
lane is its scalar fit bit for bit and takes its iterations. What they
do around the fits (means over n, the outcome
model's predictions, the sandwich sum) and the LASSO column's Gram
products are batched and reassociate against the scalar forms: those
columns are held at :data:`MAX_VMAP_COLLAPSE_ULP`, the JAX package's
bound.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np
import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.scenarios.dgp import (
    DGPSpec,
    data_cell_id,
    estimator_salt,
    generate,
)

#: bump when the cell function's derivation chain changes shape: old
#: journals must not resume against new numerics. The JAX package's tag.
SCHEMA_TAG = "scenarios-v1"


@dataclasses.dataclass(frozen=True)
class ScenarioEstimator:
    """One estimator the matrix can schedule.

    ``fn(spec, x, w, y, key) -> (ate, se)`` is the one-replicate form
    (the scalar replay and the sequential path). ``batched(spec, x, w, y,
    keys) -> (ate (B,), se (B,))`` is the column form over lanes x (B, n,
    p), w and y (B, n), keys (B, 2), ``fn`` itself where its cores take a
    batch; a vmapped estimator without one runs ``fn`` lane by lane. ``has_se`` gates the coverage and power
    aggregates (the LASSO point estimate carries ``se=NaN``)."""

    name: str
    fn: Callable
    vmapped: bool = True
    has_se: bool = True
    #: GLM/OLS designs need n > p + 2 (intercept and treatment columns);
    #: the planner refuses inapplicable (DGP, estimator) columns.
    needs_tall: bool = True
    #: whether the batched column is bit-identical to its scalar replay:
    #: True where both forms are one lane function (``naive``); False
    #: where batched products reassociate (held at MAX_VMAP_COLLAPSE_ULP).
    vmap_collapse_exact: bool = False
    batched: Callable | None = None

    def applicable(self, spec: DGPSpec) -> bool:
        return (not self.needs_tall) or spec.n > spec.p + 2

    def run_batched(self, spec, x, w, y, keys):
        if self.batched is not None:
            return self.batched(spec, x, w, y, keys)
        outs = [self.fn(spec, x[i], w[i], y[i], keys[i]) for i in range(x.shape[0])]
        return tuple(torch.stack([torch.as_tensor(o[j], dtype=x.dtype, device=x.device)
                                  for o in outs]) for j in (0, 1))


# The next four take one replicate or a column of lanes alike.


def _est_naive(spec, x, w, y, key):
    from ate_replication_causalml_torch.estimators.naive import _naive_core_lanes

    return _naive_core_lanes(w, y)


def _est_ols(spec, x, w, y, key):
    from ate_replication_causalml_torch.estimators.ols import _direct_core

    return _direct_core(x, w, y)


def _est_ipw_logit(spec, x, w, y, key):
    from ate_replication_causalml_torch.estimators.ipw import _psw_core, logistic_propensity

    return _psw_core(x, w, y, logistic_propensity(x, w))


def _est_aipw_logit(spec, x, w, y, key):
    """Textbook AIPW (``compat="fixed"`` sign, the doubly robust form)
    with the sandwich SE: the estimator the coverage theory is about."""
    from ate_replication_causalml_torch.estimators.aipw import _outcome_model_mu, aipw_sandwich_se
    from ate_replication_causalml_torch.ops import bootstrap as bt
    from ate_replication_causalml_torch.ops.glm import logistic_glm
    from ate_replication_causalml_torch.ops.linalg import add_intercept

    p = logistic_glm(add_intercept(x), w).fitted
    mu0, mu1 = _outcome_model_mu(x, w, y)
    tau = bt._aipw_tau(w, y, p, mu0, mu1, -1.0)
    return tau, aipw_sandwich_se(w, y, p, mu0, mu1, tau)


def _lasso_design(x, w):
    xw = torch.cat([x, w[..., None]], dim=-1)
    pfac = torch.cat([torch.ones(x.shape[-1], dtype=xw.dtype, device=xw.device),
                      torch.zeros(1, dtype=xw.dtype, device=xw.device)])
    return xw, pfac


def _est_lasso(spec, x, w, y, key):
    """Single-equation LASSO (W never shrunk), the p≫n column's
    estimator. Point estimate only, like the reference's no-SE LASSO
    rows."""
    from ate_replication_causalml_torch.ops.lasso import cv_glmnet, default_foldid

    xw, pfac = _lasso_design(x, w)
    cv = cv_glmnet(xw, y, family="gaussian", penalty_factor=pfac,
                   foldid=default_foldid(key, x.shape[0]))
    _, coefs = cv.coef_at("1se")
    return coefs[-1], torch.full((), torch.nan, dtype=xw.dtype, device=xw.device)


def _lasso_batched(spec, x, w, y, keys):
    """Every lane's full and fold fits in one batch of B·11 (on the card
    one ``cd_path`` launch), each lane its own folds and λ-selection."""
    from ate_replication_causalml_torch.ops.lasso import cv_glmnet_lanes, default_foldid

    xw, pfac = _lasso_design(x, w)
    cv = cv_glmnet_lanes(xw, y, penalty_factor=pfac,
                         foldids=default_foldid(keys, x.shape[-2]))
    lanes = torch.arange(x.shape[0], device=x.device)
    ate = cv.path.coefs[lanes, cv.index_1se, -1]
    return ate, torch.full_like(ate, torch.nan)


def _est_aipw_rf(spec, x, w, y, key):
    """AIPW over a micro random-forest OOB propensity: the
    representative non-vmappable engine. Each dispatch goes through the
    forest's own path (on the card: ``hist_dense``, ``route_advance``,
    ``node_sums`` and ``leaf_record``)."""
    from ate_replication_causalml_torch.data.frame import CausalFrame
    from ate_replication_causalml_torch.estimators.aipw import doubly_robust
    from ate_replication_causalml_torch.models.forest import rf_oob_propensity

    frame = CausalFrame(x=x, w=w, y=y, schema=None)
    res = doubly_robust(
        frame,
        lambda f: rf_oob_propensity(f, key=key, n_trees=16, depth=4),
        compat="fixed",
    )
    return res.ate, res.se


#: ulp budget (units of f32 spacing at the compared magnitude) for
#: columns whose batched form reassociates against the scalar replay:
#: the JAX package's bound, kept.
MAX_VMAP_COLLAPSE_ULP = 512.0

SCENARIO_ESTIMATORS: dict[str, ScenarioEstimator] = {
    e.name: e
    for e in (
        ScenarioEstimator("naive", _est_naive, needs_tall=False,
                          vmap_collapse_exact=True, batched=_est_naive),
        ScenarioEstimator("ols", _est_ols, batched=_est_ols),
        ScenarioEstimator("ipw_logit", _est_ipw_logit, batched=_est_ipw_logit),
        ScenarioEstimator("aipw_logit", _est_aipw_logit, batched=_est_aipw_logit),
        ScenarioEstimator("lasso", _est_lasso, has_se=False, needs_tall=False,
                          batched=_lasso_batched),
        ScenarioEstimator("aipw_rf", _est_aipw_rf, vmapped=False),
    )
}


def cell_fn(spec: DGPSpec, est: ScenarioEstimator) -> Callable:
    """The per-replicate function ``(root_key, cell_id) -> (ate, se,
    tau_true)``, the scalar replay. The data key is ``fold_in(root,
    cell_id)`` (every estimator of a (DGP, rep) row sees the same draw);
    the estimator's private key folds a per-estimator salt off it."""
    salt = estimator_salt(est.name)

    def run(root_key, cid):
        data_key = rnd.fold_in(root_key, int(cid))
        x, w, y, tau_true = generate(spec, data_key)
        ate, se = est.fn(spec, x, w, y, rnd.fold_in(data_key, salt))
        return (torch.as_tensor(ate, dtype=x.dtype, device=x.device),
                torch.as_tensor(se, dtype=x.dtype, device=x.device), tau_true)

    return run


def generate_cell(spec: DGPSpec, root_key, cid: int, salt: int):
    """One cell's draw and its estimator key, for the sequential
    (forest) path: ``(x, w, y, tau_true, est_key)``."""
    data_key = rnd.fold_in(root_key, int(cid))
    x, w, y, tau_true = generate(spec, data_key)
    return x, w, y, tau_true, rnd.fold_in(data_key, salt)


def pad_ids(dgp_name: str, batch: tuple[int, ...], width: int) -> np.ndarray:
    """Cell-id operand of one batch: the final partial batch pads to the
    column's width with duplicate ids (one shape a column). Rows mode
    discards the padded outputs; aggregate mode masks them."""
    return np.asarray(
        [data_cell_id(dgp_name, r) for r in batch]
        + [data_cell_id(dgp_name, batch[0])] * (width - len(batch)),
        dtype=np.uint32,
    )


def batch_mask(batch: tuple[int, ...], width: int, dtype: str = "float32") -> np.ndarray:
    """The matching lane mask: 1.0 on real lanes, 0.0 on padding."""
    return np.asarray([1.0] * len(batch) + [0.0] * (width - len(batch)), dtype=dtype)


def column_cache_key(spec: DGPSpec, estimator: str, width: int | None) -> tuple:
    """The cache identity of one scenario column: the DGP spec's full
    field tuple, the estimator name, the batch width (``None`` = the
    scalar replay) and the schema tag."""
    return (SCHEMA_TAG, spec.fields(), estimator, width)


#: column callables by column_cache_key, process-global, under _EXE_LOCK.
_EXECUTABLES: dict[tuple, object] = {}
_EXE_LOCK = threading.Lock()


def clear_executables() -> None:
    """Test hook: drop the column cache."""
    with _EXE_LOCK:
        _EXECUTABLES.clear()


def compile_event_count() -> float:
    """The port's compile events so far: kernel library builds and CUDA
    graph captures (the JAX package counts XLA compiles; the port traces
    and compiles nothing else)."""
    total = 0.0
    for family in ("kernel_builds_total", "graph_captures_total"):
        vals = obs.REGISTRY.peek(family)
        total += float(sum(vals.values())) if vals else 0.0
    return total


def _compile_counter():
    return obs.counter(
        "scenario_column_compile_total",
        "scenario column executables AOT-compiled, by column and kind",
    )


def cached_executable(key: tuple, build: Callable, column: str, kind: str):
    """The fit-once cache discipline every scenario callable shares:
    lock-guarded lookup, ``build()`` outside the lock, ``setdefault``
    commit (a race loses benignly: both builds are the same function and
    the first writer wins the slot), and one per-column tick of
    ``scenario_column_compile_total`` for the thread that built it."""
    with _EXE_LOCK:
        exe = _EXECUTABLES.get(key)
    if exe is not None:
        return exe
    built = build()
    with _EXE_LOCK:
        exe = _EXECUTABLES.setdefault(key, built)
    _compile_counter().inc(1, column=column, kind=kind)
    return exe


def _ids_tensor(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(ids, dtype=np.uint32).astype(np.int64), device=device)


def lane_outputs(spec: DGPSpec, est: ScenarioEstimator, root_key, ids):
    """The column's lanes: ``(ate (W,), se (W,), tau_true (W,))`` of the
    cell ids ``ids`` (W,), on the root key's device."""
    data_keys = rnd.fold_in(root_key, _ids_tensor(ids, root_key.device))
    x, w, y, tau_true = generate(spec, data_keys)
    ate, se = est.run_batched(spec, x, w, y, rnd.fold_in(data_keys, estimator_salt(est.name)))
    return ate, se, tau_true


def column_executable(spec: DGPSpec, est: ScenarioEstimator, width: int, column: str = ""):
    """The column's one batched callable: ``exe(root_key, cell_ids[width])
    -> (ate[width], se[width], tau_true[width])``, made on first request
    and shared by every batch of the column (and by identical columns of
    later matrices in the process)."""
    if not est.vmapped:
        raise ValueError(
            f"estimator {est.name!r} is not vmappable — the planner must "
            "pack it at width 1 through the sequential path"
        )
    key = column_cache_key(spec, est.name, width)

    def build():
        def exe(root_key, ids):
            if len(ids) != width:
                raise ValueError(f"column built for width {width}, got {len(ids)} ids")
            return lane_outputs(spec, est, root_key, ids)

        return exe

    return cached_executable(key, build, column or f"{spec.name}:{est.name}", "batched")


def scalar_executable(spec: DGPSpec, est: ScenarioEstimator, column: str = ""):
    """The scalar replay of the same column: ``exe(root_key, cell_id) ->
    (ate, se, tau_true)``, one dispatch a cell."""
    key = column_cache_key(spec, est.name, None)
    return cached_executable(key, lambda: cell_fn(spec, est),
                             column or f"{spec.name}:{est.name}", "scalar")
