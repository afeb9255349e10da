"""The residual_balancing row (``estimators/balance.py``) against the JAX
package on the ``prep_small`` frame in float32, the sweep's dtype
(``tests/conftest.py``: 20,000-row pool, 8,000-row sample, bias injection
to 1,741 rows, 21 covariates), with the default key ``key(0)``.

Exact: each arm's fold ids (``default_foldid`` of its half of
``split(key)``: treated on the second, control on the first), each
arm's selected ``index_min``, and each arm's ADMM iteration count.

Bound: τ and SE |Δ| ≤ 5e-5 (``BALANCE_BOUND``). The float32 covariate
mean (the QP's target) is a sum in another order; γ is the float64 ADMM
iterate, equal to rounding (``tests/test_torch_qp.py``), cast to float32;
the arm's elastic-net path comes from coordinate descent that stops once
max_j G_jj·Δβ_j² < 1e-7, so two runs that round differently can stop a
sweep apart (``tests/test_torch_lasso_est.py``'s 5e-5 on path
coefficients). Largest seen: |Δτ| 2.4e-7 here, 1.5e-6 at the notebook's
size (``scripts/torch_parity.py --rows balance``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame as TFrame
from ate_replication_causalml_torch.estimators import balance as tb
from ate_replication_causalml_torch.ops import lasso as tla
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu.data.frame import CausalFrame as JFrame
from ate_replication_causalml_tpu.ops import lasso as jla

jb = importlib.import_module("ate_replication_causalml_tpu.estimators.balance")

BALANCE_BOUND = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file: the ADMM's small float64
    matrix-vector products, multithreaded on a CPU the suite's parallel
    workers keep busy, wait on their threads (one n = 4,000 solve on an
    8-core CPU beside five busy processes: 5.3 s on one thread, 59.5 s on
    eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(prep_small):
    _, fm, _ = prep_small
    arrs = [np.array(a, np.float32) for a in (fm.x, fm.w, fm.y)]
    return JFrame(*(jnp.asarray(a) for a in arrs)), TFrame(*(torch.as_tensor(a) for a in arrs))


def _record(mp, mod, name, sink):
    fn = getattr(mod, name)

    def rec(*a, **k):
        out = fn(*a, **k)
        sink.append(out)
        return out

    mp.setattr(mod, name, rec)


@pytest.fixture(scope="module")
def rows(prep_small):
    """Both packages' row at the default key, with each arm's QP outcome
    (the port's and the JAX package's) and the port's CV fits."""
    jframe, tframe = _frames(prep_small)
    jqp, tqp, tcv = [], [], []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        _record(mp, jb, "approx_balance_sol", jqp)
        ref = jb.residual_balance_ate(jframe, max_iters=12_000)
        treated = np.asarray(jframe.w) > 0.5
        k0, k1 = jax.random.split(jax.random.key(0))
        arms = {"treated": (treated, k1), "control": (~treated, k0)}
        jarm = {}
        for arm, (mask, k) in arms.items():
            cv = jla.cv_glmnet(jframe.x[mask], jframe.y[mask], family="gaussian", alpha=0.9, key=k)
            jarm[arm] = {"fold": np.asarray(jla.default_foldid(k, int(mask.sum()))),
                         "index_min": int(cv.index_min)}
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, tb, "approx_balance_sol", tqp)
        _record(mp, tb, "cv_glmnet", tcv)
        got = tb.residual_balance_ate(tframe, max_iters=12_000)
    tk0, tk1 = rnd.split(rnd.key(0, device="cpu")).unbind(dim=-2)
    tarm = {"treated": (treated, tk1), "control": (~treated, tk0)}
    return dict(ref=ref, got=got, jqp=jqp, tqp=tqp, tcv=tcv, jarm=jarm, tarm=tarm)


def test_row_within_bound(rows):
    ref, got = rows["ref"], rows["got"]
    assert got.method == ref.method == "residual_balancing"
    assert abs(got.ate - ref.ate) <= BALANCE_BOUND, (got.ate, ref.ate)
    assert abs(got.se - ref.se) <= BALANCE_BOUND, (got.se, ref.se)
    assert got.se > 0 and got.lower_ci < got.ate < got.upper_ci


@pytest.mark.parametrize("i,arm", [(0, "treated"), (1, "control")])
def test_arms_fold_ids_index_and_iterations_equal(rows, i, arm):
    mask, key = rows["tarm"][arm]
    fold = tla.default_foldid(key, int(mask.sum())).numpy()
    assert np.array_equal(fold, rows["jarm"][arm]["fold"])
    assert int(rows["tcv"][i].index_min) == rows["jarm"][arm]["index_min"]
    (_, t_worst, t_iters), (_, j_worst, j_iters) = rows["tqp"][i], rows["jqp"][i]
    assert t_iters == int(j_iters) < 12_000
    assert float(t_worst) <= 1e-7 and float(j_worst) <= 1e-7


def test_max_iters_warning_and_point_only(prep_small):
    """A budget of 5 ADMM iterations leaves both arms far from the
    tolerance: both packages warn, and the port's point-only row
    (``estimate_se=False``) is the JAX package's τ within the bound."""
    jframe, tframe = _frames(prep_small)
    with pytest.warns(RuntimeWarning, match="hit max_iters=5"), jax.enable_x64(False):
        ref = jb.residual_balance_ate(jframe, max_iters=5)
    with pytest.warns(RuntimeWarning, match="hit max_iters=5"):
        got = tb.residual_balance_ate(tframe, max_iters=5, estimate_se=False)
    assert abs(got.ate - ref.ate) <= BALANCE_BOUND
    assert got.lower_ci == got.ate == got.upper_ci and np.isnan(got.se)
