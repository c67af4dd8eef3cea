"""Plotting + posterior summary utilities (port of rainier_tpu/viz/plots.py,
a copy of it: the port imports nothing of the JAX package).

Counterpart of rainier-notebook's EvilPlot wrappers
(rainier-notebook/.../package.scala:60-476: density, scatter, contour,
line(s), whiskers, shade, hdpi, precis, coeftab) rebuilt on matplotlib.
All functions accept either plain arrays or (trace, Real) pairs; a
trace's values come from ``Trace.evaluate``, in float64 on the host from
its draws' host copy, wherever the draws were made.
Import is lazy/gated so headless installs without matplotlib still work.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt
    except Exception as e:  # pragma: no cover
        raise RuntimeError(
            "matplotlib is required for rainier_tpu_torch.viz plots") from e


def _values(trace_or_array, expr=None) -> np.ndarray:
    if expr is not None:
        return np.asarray(trace_or_array.evaluate(expr)).ravel()
    return np.asarray(trace_or_array).ravel()


def density(x, expr=None, bins: int = 60, ax=None, label=None, **kw):
    """Histogram-density of a posterior quantity (notebook `density`)."""
    plt = _plt()
    v = _values(x, expr)
    ax = ax or plt.gca()
    ax.hist(v, bins=bins, density=True, alpha=0.7, label=label, **kw)
    if label:
        ax.legend()
    return ax


def scatter(x, y, ax=None, **kw):
    plt = _plt()
    ax = ax or plt.gca()
    ax.scatter(np.asarray(x).ravel(), np.asarray(y).ravel(),
               s=kw.pop("s", 4), alpha=kw.pop("alpha", 0.4), **kw)
    return ax


def contour(x, y, bins: int = 40, ax=None, **kw):
    plt = _plt()
    ax = ax or plt.gca()
    h, xe, ye = np.histogram2d(np.asarray(x).ravel(),
                               np.asarray(y).ravel(), bins=bins)
    ax.contour(0.5 * (xe[:-1] + xe[1:]), 0.5 * (ye[:-1] + ye[1:]), h.T,
               **kw)
    return ax


def line(xs, ys, ax=None, **kw):
    plt = _plt()
    ax = ax or plt.gca()
    ax.plot(np.asarray(xs), np.asarray(ys), **kw)
    return ax


def lines(xs, ys_seq, ax=None, labels=None, **kw):
    """Plot several series over the same x-axis (notebook `lines`,
    rainier-notebook/.../package.scala:113-121 — there: a Double =>
    Seq[Double] function sampled over bounds; here: precomputed series
    or a callable applied to xs).

    `ys_seq` is *series-major*: a list of per-series sequences (each of
    len(xs)), a (n_series, n_points) array, or a callable x -> sequence
    of per-series values.  Ragged series are allowed (each is plotted
    against its own prefix of xs).  `labels` may be shorter than the
    number of series; unlabeled series get no legend entry."""
    plt = _plt()
    ax = ax or plt.gca()
    xs = np.asarray(xs)
    if callable(ys_seq):
        ys_seq = np.stack([np.asarray(ys_seq(x)) for x in xs], axis=-1)
    if isinstance(ys_seq, np.ndarray):
        series = [ys_seq] if ys_seq.ndim == 1 else list(ys_seq)
    else:
        # iterate, not np.asarray on the whole input: a ragged list of
        # series must not raise, and orientation stays series-major
        rows = list(ys_seq)
        if rows and np.ndim(rows[0]) == 0:  # flat list = one series
            series = [np.asarray(rows)]
        else:
            series = [np.asarray(ys) for ys in rows]
    for i, ys in enumerate(series):
        label = labels[i] if labels is not None and i < len(labels) \
            else None
        ax.plot(xs[:len(ys)], ys, label=label, **kw)
    if labels:
        ax.legend()
    return ax


def load_csv(path: str, delimiter: str = ","):
    """Load a CSV with a header row into {column: list} — the notebook
    `loadCSV` helper (rainier-notebook/.../package.scala:316-325).
    Numeric columns become floats; everything else stays str."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter=delimiter))
    out: dict = {}
    for name in (rows[0].keys() if rows else []):
        vals = [r[name] for r in rows]
        try:
            out[name] = [float(v) for v in vals]
        except (TypeError, ValueError):
            out[name] = vals
    return out


def shade(xs, lower, upper, ax=None, **kw):
    """Shaded interval band (notebook `shade`)."""
    plt = _plt()
    ax = ax or plt.gca()
    ax.fill_between(np.asarray(xs), np.asarray(lower), np.asarray(upper),
                    alpha=kw.pop("alpha", 0.3), **kw)
    return ax


def hdpi(values, prob: float = 0.89) -> tuple[float, float]:
    """Highest-density posterior interval (notebook `hdpi`)."""
    v = np.sort(np.asarray(values).ravel())
    n = len(v)
    w = max(int(np.ceil(prob * n)), 1)
    if w >= n:
        return float(v[0]), float(v[-1])
    widths = v[w:] - v[:-w]
    i = int(np.argmin(widths))
    return float(v[i]), float(v[i + w])


def whiskers(named_values: dict, prob: float = 0.89, ax=None):
    """Per-quantity whisker (interval) plot (notebook `whiskers`)."""
    plt = _plt()
    ax = ax or plt.gca()
    names = list(named_values)
    for i, name in enumerate(names):
        v = np.asarray(named_values[name]).ravel()
        lo, hi = hdpi(v, prob)
        ax.plot([lo, hi], [i, i], "-", lw=2)
        ax.plot([np.mean(v)], [i], "o")
    ax.set_yticks(range(len(names)), names)
    return ax


def mean(values) -> float:
    return float(np.mean(np.asarray(values)))


def stddev(values) -> float:
    return float(np.std(np.asarray(values)))


def standardize(values) -> np.ndarray:
    v = np.asarray(values, dtype=np.float64)
    return (v - v.mean()) / v.std()


def precis(named_values: dict, prob: float = 0.89) -> str:
    """Posterior summary table (notebook `precis`): mean, sd, hdpi."""
    rows = [f"{'':>12} {'mean':>9} {'sd':>9} "
            f"{f'{prob:.0%} lo':>9} {f'{prob:.0%} hi':>9}"]
    for name, v in named_values.items():
        v = np.asarray(v).ravel()
        lo, hi = hdpi(v, prob)
        rows.append(f"{name:>12} {v.mean():>9.3f} {v.std():>9.3f} "
                    f"{lo:>9.3f} {hi:>9.3f}")
    return "\n".join(rows)


def coeftab(models: dict, prob: float = 0.89) -> str:
    """Coefficient comparison across models (notebook `coeftab`):
    models = {model_name: {coef_name: values}}."""
    coefs: list[str] = []
    for vals in models.values():
        for c in vals:
            if c not in coefs:
                coefs.append(c)
    header = f"{'':>12}" + "".join(f"{m:>12}" for m in models)
    rows = [header]
    for c in coefs:
        cells = []
        for m, vals in models.items():
            if c in vals:
                cells.append(f"{np.mean(np.asarray(vals[c])):>12.3f}")
            else:
                cells.append(f"{'—':>12}")
        rows.append(f"{c:>12}" + "".join(cells))
    return "\n".join(rows)


def show(title: str, path: str, ax=None) -> str:
    """Save the current figure (notebook `show` writes to the cell; here we
    write a png)."""
    plt = _plt()
    fig = (ax.figure if ax is not None else plt.gcf())
    fig.suptitle(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
