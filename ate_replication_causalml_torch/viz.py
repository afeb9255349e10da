"""Comparison figures: the notebook's three pointrange charts
(``ate_replication.Rmd:146-150, 209-213, 277-281``).

A copy of the JAX package's ``viz.py`` (plain Python and matplotlib).
matplotlib is imported only when a figure is drawn: a sweep run with
``plots=True`` and an output directory on a machine without matplotlib
raises (``pipeline.run_sweep`` checks before it computes anything); it
does not skip the figures.

Methods go on the y-axis, every estimate uses one hue, and the RCT oracle
is drawn as a reference band behind the marks, so "which CI brackets the
truth" is answerable at a glance. Matplotlib renders to PNG next to the
result table.
"""

from __future__ import annotations

import math
from typing import Iterable, NamedTuple, Sequence

from ate_replication_causalml_torch.estimators.base import EstimatorResult


def require_matplotlib() -> None:
    """Raise unless matplotlib can be imported (the figures need it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("plots=True needs matplotlib, which is not installed; pass "
                          "plots=False (--no-plots) to run the sweep without figures") from e


class PointrangeMark(NamedTuple):
    """One plotted row: what the chart actually drew (testable without
    parsing pixels — a blank-axes regression has an empty mark list)."""

    method: str
    ate: float
    lower: float
    upper: float
    y: float


class PointrangeChart(NamedTuple):
    figure: object                                  # matplotlib Figure
    marks: list[PointrangeMark]                     # one per method row
    oracle_band: tuple[float, float, float] | None  # (lower, upper, ate)

# Brand-neutral defaults validated for the light surface.
_SURFACE = "#fcfcfb"
_INK = "#0b0b0b"
_INK_2 = "#52514e"
_GRID = "#e4e3df"
_ESTIMATE = "#2a78d6"   # all estimate marks — one entity class, one hue
_ORACLE = "#eb6834"     # the reference band


def pointrange_figure(
    results: Sequence[EstimatorResult],
    oracle: EstimatorResult | None = None,
    title: str = "ATE estimates vs the RCT oracle",
    path: str | None = None,
    footnote: str | None = None,
):
    """Horizontal pointrange chart of estimate ± CI per method.

    ``oracle`` (the unbiased RCT difference-in-means,
    ``ate_replication.Rmd:130``) renders as a vertical line + CI band
    behind the marks. ``footnote`` annotates the chart bottom-left —
    the resilience layer uses it to name stages a degraded sweep could
    not plot. Returns a :class:`PointrangeChart` carrying the Figure
    plus the plotted arrays; saves PNG when ``path`` is given.
    """
    # Agg canvas bound to this figure only — never touches the process-
    # global backend (a notebook user's interactive backend stays live).
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    rows = list(results)
    n = len(rows)
    fig = Figure(figsize=(7.2, 1.1 + 0.52 * n), dpi=150)
    FigureCanvasAgg(fig)
    ax = fig.add_subplot(111)
    fig.patch.set_facecolor(_SURFACE)
    ax.set_facecolor(_SURFACE)

    ys = range(n - 1, -1, -1)  # first method on top
    band = None
    if oracle is not None:
        band = (float(oracle.lower_ci), float(oracle.upper_ci), float(oracle.ate))
        ax.axvspan(band[0], band[1], color=_ORACLE, alpha=0.12, lw=0)
        ax.axvline(band[2], color=_ORACLE, lw=2, label=f"RCT oracle ({band[2]:.3f})")
    marks = []
    for y, r in zip(ys, rows):
        ax.plot([r.lower_ci, r.upper_ci], [y, y], color=_ESTIMATE, lw=2,
                solid_capstyle="round", zorder=3)
        ax.plot([r.ate], [y], "o", color=_ESTIMATE, ms=7, zorder=4)
        marks.append(PointrangeMark(
            method=r.method, ate=float(r.ate),
            lower=float(r.lower_ci), upper=float(r.upper_ci), y=float(y),
        ))
    ax.set_yticks(list(ys))
    ax.set_yticklabels([r.method for r in rows], fontsize=9, color=_INK)
    ax.set_xlabel("ATE (95% CI)", fontsize=9, color=_INK_2)
    ax.set_title(title, fontsize=11, color=_INK, loc="left", pad=12)
    ax.grid(axis="x", color=_GRID, lw=0.8)
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    ax.spines["bottom"].set_color(_GRID)
    ax.tick_params(colors=_INK_2, labelsize=8)
    if oracle is not None:
        ax.legend(loc="upper right", frameon=False, fontsize=8, labelcolor=_INK_2)
    fig.tight_layout()
    if footnote:
        fig.subplots_adjust(bottom=max(0.18, fig.subplotpars.bottom + 0.06))
        fig.text(0.02, 0.02, footnote, fontsize=7.5, color=_INK_2)
    if path is not None:
        fig.savefig(path, facecolor=_SURFACE)
    return PointrangeChart(figure=fig, marks=marks, oracle_band=band)


def _plottable(r: EstimatorResult) -> bool:
    return getattr(r, "status", "ok") == "ok" and math.isfinite(r.ate)


def notebook_figures(
    results: Iterable[EstimatorResult],
    oracle: EstimatorResult | None,
    outdir: str,
) -> list[str]:
    """The notebook's three charts, same stage boundaries:
    ``rct_naive_plot`` (oracle + naive), ``compare_regression``
    (through the LASSO family), ``compare_CausalML`` (everything).

    Degraded sweeps (pipeline.py isolation policy) still render:
    ``status="failed"`` rows are dropped from the marks and named in a
    footnote instead, and ``oracle=None`` (a failed oracle stage) skips
    the reference band rather than drawing a NaN span."""
    import os

    rows_all = list(results)
    rows = [r for r in rows_all if _plottable(r)]
    failed = {r.method for r in rows_all if not _plottable(r)}
    by_method = {r.method: r for r in rows}
    paths = []

    def save(name, want_methods, title):
        subset = [by_method[m] for m in want_methods if m in by_method]
        missing = [m for m in want_methods if m in failed]
        note = ("✗ failed, not shown: " + ", ".join(missing)) if missing else None
        p = os.path.join(outdir, f"{name}.png")
        # Render WITHOUT saving, validate, then write: a blank chart
        # must fail loudly — and must not overwrite the last good PNG
        # at this path before the check runs.
        chart = pointrange_figure(subset, oracle=oracle, title=title,
                                  footnote=note)
        drawn = [m.method for m in chart.marks]
        want = [r.method for r in subset]
        if drawn != want or (oracle is not None and chart.oracle_band is None):
            raise RuntimeError(
                f"figure {name!r} did not draw what was requested: "
                f"drawn={drawn} wanted={want} band={chart.oracle_band}"
            )
        chart.figure.savefig(p, facecolor=_SURFACE)
        paths.append(p)

    save("rct_naive_plot", ("naive",),
         "Naive estimate on the biased sample vs RCT oracle")

    regression_methods = (
        "naive", "Direct Method", "Propensity_Weighting", "Propensity_Regression",
        "Propensity_Weighting_LASSOPS", "Single-equation LASSO", "Usual LASSO",
    )
    save("compare_regression", regression_methods,
         "Regression extensions vs RCT oracle")

    save("compare_CausalML", [r.method for r in rows_all],
         "All estimators vs RCT oracle")
    return paths
