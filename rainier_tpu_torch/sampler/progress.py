"""Progress reporting (port of rainier_tpu/sampler/progress.py;
counterpart of sampler/Progress.scala:3-42).

With a Progress attached, the driver runs warmup and sampling in
segments and refreshes between them with the carried StatsState: chain
count, message, iterations, acceptance rate, E-BFMI, step size and
divergences, as the reference's throttled refresh does.  The stats may
live on the card: each refresh and finish copies them to the host once
(``stats.to_host``) before it reads them.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .stats import accept_rate, bfmi, to_host


def _host_step(step_size) -> np.ndarray:
    if isinstance(step_size, torch.Tensor):
        return step_size.detach().cpu().numpy()
    return np.asarray(step_size)


class Progress:
    #: minimum seconds between refreshes (Progress.outputEverySeconds)
    output_every_seconds: float = 0.5

    def start(self, n_chains: int) -> None:
        pass

    def refresh(self, message: str, iterations: int, total: int, stats,
                step_size) -> None:
        pass

    def finish(self, message: str, stats, step_size) -> None:
        pass


class SilentProgress(Progress):
    output_every_seconds = 1e100


class WindowedRates:
    """Recent-window telemetry between refreshes (the reference's
    statsWindow ring buffers, Stats.scala:3-16; here the window is the
    refresh interval).  Fed the cumulative StatsState at each refresh, it
    differences against the previous refresh to give the window's
    accept rate and grad-evals/s."""

    def __init__(self):
        self._prev = None           # (accept_sum, iters, grads, wall)

    def update(self, stats):
        stats = to_host(stats)
        now = time.time()
        acc_sum = float(np.sum(stats.accept_sum))
        iters = float(np.sum(stats.iterations))
        grads = float(np.sum(stats.grad_evals))
        prev, self._prev = self._prev, (acc_sum, iters, grads, now)
        if prev is None:
            return None, None
        d_acc = acc_sum - prev[0]
        d_it = iters - prev[1]
        d_gr = grads - prev[2]
        dt = now - prev[3]
        win_accept = d_acc / d_it if d_it > 0 else None
        win_grad_rate = d_gr / dt if dt > 0 else None
        return win_accept, win_grad_rate


class ConsoleProgress(Progress):
    def __init__(self, out=sys.stderr):
        self.out = out
        self._last = 0.0
        self._n_chains = 0
        self._t0 = time.time()
        self._window = WindowedRates()

    def start(self, n_chains: int) -> None:
        self._n_chains = n_chains
        self._t0 = time.time()
        self._window = WindowedRates()
        print(f"sampling {n_chains} chains", file=self.out)

    def _line(self, message, iterations, total, stats, step_size):
        stats = to_host(stats)
        acc = float(np.mean(accept_rate(stats)))
        b = float(np.mean(bfmi(stats)))
        dv = int(np.sum(stats.divergences))
        ss = float(np.mean(_host_step(step_size)))
        rate = ""
        ge = float(np.sum(stats.grad_evals))
        dt = time.time() - self._t0
        if dt > 0:
            rate = f" grad evals/s {ge / dt:,.0f}"
        win_acc, win_rate = self._window.update(stats)
        win = ""
        if win_acc is not None:
            win = f"  [window: accept {win_acc:.2f}"
            if win_rate is not None:
                win += f", grad evals/s {win_rate:,.0f}"
            win += "]"
        return (f"{message} {iterations}/{total}  accept {acc:.2f}  "
                f"E-BFMI {b:.2f}  step {ss:.3g}  divergences {dv}{rate}"
                f"{win}")

    def refresh(self, message, iterations, total, stats, step_size) -> None:
        now = time.time()
        if now - self._last < self.output_every_seconds:
            return
        self._last = now
        print(self._line(message, iterations, total, stats, step_size),
              file=self.out)

    def finish(self, message, stats, step_size) -> None:
        stats = to_host(stats)
        n = int(np.max(stats.iterations))
        print(self._line(message, n, n, stats, step_size), file=self.out)


class HTMLProgress(Progress):
    """Live-updating per-chain HTML table for Jupyter (counterpart of
    rainier-notebook HTMLProgress.scala:8-81: iterations, accept rate,
    E-BFMI, step size, divergences per chain, refreshed in place via an
    IPython display handle).  Falls back to ConsoleProgress when IPython
    is unavailable."""

    MAX_ROWS = 16  # at 4096 chains a per-chain table is useless; cap it

    def __init__(self):
        self._handle = None
        self._t0 = time.time()
        self._last = 0.0
        self._n_chains = 0
        self._window = WindowedRates()
        try:
            from IPython.display import display, HTML  # noqa: F401

            self._display = display
            self._HTML = HTML
        except ImportError:  # pragma: no cover - notebook-only path
            self._display = None
            self._fallback = ConsoleProgress()

    def start(self, n_chains: int) -> None:
        self._n_chains = n_chains
        self._t0 = time.time()
        self._window = WindowedRates()
        if self._display is None:
            self._fallback.start(n_chains)

    def _render(self, message, iterations, total, stats, step_size) -> str:
        stats = to_host(stats)
        acc = np.atleast_1d(accept_rate(stats))
        b = np.atleast_1d(bfmi(stats))
        dv = np.atleast_1d(stats.divergences)
        ss = np.atleast_1d(_host_step(step_size))
        n = min(len(acc), self.MAX_ROWS)
        pct = 100.0 * iterations / max(total, 1)
        rows = "".join(
            f"<tr><td>{i}</td><td>{acc[i]:.2f}</td><td>{b[i]:.2f}</td>"
            f"<td>{ss[min(i, len(ss) - 1)]:.3g}</td>"
            f"<td>{int(dv[i])}</td></tr>"
            for i in range(n))
        more = ("<tr><td colspan=5>… "
                f"{len(acc) - n} more chains</td></tr>" if len(acc) > n
                else "")
        win_acc, win_rate = self._window.update(stats)
        win = ""
        if win_acc is not None:
            win = f" — window: accept {win_acc:.2f}"
            if win_rate is not None:
                win += f", grad evals/s {win_rate:,.0f}"
        return (f"<div><b>{message}</b> {iterations}/{total} ({pct:.0f}%)"
                f"{win}"
                f"<table><tr><th>chain</th><th>accept</th><th>E-BFMI</th>"
                f"<th>step</th><th>divergences</th></tr>{rows}{more}"
                f"</table></div>")

    def refresh(self, message, iterations, total, stats, step_size) -> None:
        if self._display is None:
            self._fallback.refresh(message, iterations, total, stats,
                                   step_size)
            return
        now = time.time()
        if now - self._last < self.output_every_seconds:
            return
        self._last = now
        html = self._HTML(self._render(message, iterations, total, stats,
                                       step_size))
        if self._handle is None:
            self._handle = self._display(html, display_id=True)
        else:
            self._handle.update(html)

    def finish(self, message, stats, step_size) -> None:
        if self._display is None:
            self._fallback.finish(message, stats, step_size)
            return
        stats = to_host(stats)
        total = int(np.max(stats.iterations))
        html = self._HTML(self._render(message, total, total, stats,
                                       step_size))
        if self._handle is None:
            self._display(html, display_id=True)
        else:
            self._handle.update(html)
