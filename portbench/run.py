"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Set-up makes the configuration's data,
builds its model with rainier_tpu_torch, takes the kernel from the
program's build cache (built there on a checkout's first run) and runs one
short fit at the cell's chains and shapes.  The window then runs whole
``Model.sample(kernel="fused!")`` fits back to back, each with its own seed
drawn from --seed, for --seconds; the fits that end inside it count (the
first always does).  After the window: the peak device memory, the
comparison with the plain reference that decides `correct`, the metrics,
and last, before the result is printed, the check that no JAX module was
loaded.  The last line of standard
output is the result's JSON; the numbers compared, each beside its limit,
are the last lines of standard error.  With --trace 1 the window runs
under torch.profiler and the per-layer metrics are reported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "rainier_tpu")

#: warmup iterations and draws of the set-up fit
SETUP_FIT = (20, 10)


def _cache_dirs(root: Path):
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Probes:
    """The benchmark's own probes around the calls into two layers of the
    program: the arguments each fit hands its sampling kernel
    (``ops.fused_hmc.prepare_fused_hmc``, which ``fused_hmc`` calls), and
    the outputs of chosen evaluations of warmup's density (the compiled
    density's ``batched_logp_and_grad_fn``).  They keep references and do
    no device work inside a fit."""

    def __init__(self, density):
        self.density = density
        self.kernel = None
        self.warm = []
        self.want = ()
        self.evals = 0

    def __enter__(self):
        from rainier_tpu_torch.ops import fused_hmc as F

        self._F, self._prepare = F, F.prepare_fused_hmc
        self._lpg_fn = self.density.batched_logp_and_grad_fn

        def prepare(density, q0, **kw):
            self.kernel = dict(kw, q0=q0)
            return self._prepare(density, q0, **kw)

        def lpg_fn():
            lpg = self._lpg_fn()

            def recorded(q, cols):
                lp, g = lpg(q, cols)
                if self.evals in self.want:
                    self.warm.append((q, lp, g))
                self.evals += 1
                return lp, g

            return recorded

        F.prepare_fused_hmc = prepare
        self.density.batched_logp_and_grad_fn = lpg_fn
        return self

    def __exit__(self, *exc):
        self._F.prepare_fused_hmc = self._prepare
        del self.density.batched_logp_and_grad_fn

    def start(self, want):
        self.kernel, self.warm, self.want, self.evals = None, [], want, 0


class Fit:
    """One fit of the window: its wall seconds, the program's timings,
    its draws (host), whether it ended inside the window."""

    def __init__(self, wall, timings, draws, counted):
        self.wall, self.timings, self.draws = wall, timings, draws
        self.counted = counted


class Cell:
    """One cell's configuration, traffic and model, and its fits."""

    def __init__(self, workload: str, seed: int, device, root: Path = ROOT,
                 sizes=None, base: Path = BASE, traffic=None):
        import numpy as np
        import rainier_tpu_torch as rt
        from portbench import manifest

        self.rt, self.np, self.device = rt, np, device
        self.bench = manifest.load(root)
        self.cell = manifest.workload(self.bench, workload)
        self.cfg = manifest.config(root, self.bench, self.cell["config"])
        self.sizes = dict(self.cfg.sizes, **(sizes or {}))
        self.traffic = dict(manifest.traffic(
            self.cell["traffic"], self.cell["config"], base), **(traffic or {}))
        self.data = self.cfg.ref.make_data(self.sizes)
        self.model, self.collect = self.cfg.model.build(rt, self.data,
                                                        self.sizes)
        self.density = self.model.density()
        self.dim = self.density.n_vars
        self.rng = np.random.default_rng([seed % 2 ** 64, 24])
        self.records = []

    def reseed(self, seed: int):
        """Fits drawn anew from `seed`, the records cleared."""
        self.rng = self.np.random.default_rng([seed % 2 ** 64, 24])
        self.records = []

    def fit(self, probes, warmup, draws):
        """One whole fit under the probes: (wall seconds, Trace)."""
        seed = int(self.rng.integers(0, 2 ** 62))
        chk = self.sizes["check"]
        evals = warmup * self.traffic["hmc_steps"]
        want = {0} | {int(i) for i in self.rng.integers(
            1, max(evals, 2), chk["warm_evals"] - 1)}
        probes.start(want)
        cfg = self.rt.SamplerConfig(
            warmup, draws, sampler=self.rt.HMC(self.traffic["hmc_steps"]),
            thin=self.traffic["thin"])
        t0 = time.perf_counter()
        tr = self.model.sample(cfg, n_chains=self.traffic["chains"],
                               seed=seed, kernel="fused!",
                               collect_idx=self.collect, device=self.device)
        _sync(self.device)
        return time.perf_counter() - t0, tr

    def record(self, probes, tr, draws_host):
        """Keep what the check needs of a fit: the replayed chains' start,
        step size, scale, draws and acceptance, and warmup's recorded
        evaluations on chains drawn over the whole batch."""
        import torch
        from portbench.check import FitRecord

        np = self.np
        k = probes.kernel
        if k is None:
            raise RuntimeError("the fit did not call the sampling kernel "
                               "(ops.fused_hmc.prepare_fused_hmc)")
        chk = self.sizes["check"]
        n = self.traffic["chains"]
        chains = np.sort(self.rng.choice(n, min(chk["replay_chains"], n),
                                         replace=False))
        dev = k["q0"].device
        ci = torch.as_tensor(chains, device=dev)
        q0 = k["q0"][:, ci].T.double()
        eps = torch.as_tensor(k["step_size"], device=dev).reshape(-1)
        eps = eps.expand(n)[ci].double()
        imd = k.get("inv_mass_diag")
        scale = torch.ones_like(q0) if imd is None else torch.sqrt(
            torch.as_tensor(imd, device=dev).expand(n, self.dim)[ci]
            .double())
        draws = torch.as_tensor(draws_host[chains], device=dev).double()
        accept = torch.as_tensor(tr.accept_rate()[chains], device=dev)
        iters = chk["replay_iters"]
        full = self.collect is None
        d = draws.shape[1]
        starts = torch.as_tensor(
            self.rng.integers(0, d - iters + 1, len(chains)) if full
            else np.zeros(len(chains), dtype=np.int64), device=dev)
        wc = torch.as_tensor(np.sort(self.rng.choice(
            n, min(chk["warm_chains"], n), replace=False)), device=dev)
        warm = [(q[wc].double(), lp[wc].double(), g[wc].double())
                for q, lp, g in probes.warm]
        probes.warm = []
        self.records.append(FitRecord(ci, q0, eps, scale, draws, accept,
                                      int(k["seed"]), int(k["n_steps"]),
                                      warm, starts))

    def readings(self, control: bool = False):
        """The numbers compared over the recorded fits, by the reference
        in float64 (and the control in bfloat16)."""
        import torch
        from portbench import check

        ref = self.cfg.ref
        dev = self.records[0].q0.device
        data = {k: torch.as_tensor(v, device=dev) for k, v in
                self.data.items()}

        def lpg(q):
            return ref.lp_grad(q, data, self.sizes)

        def low(q):
            return ref.lp_grad(q, data, self.sizes, low=torch.bfloat16)

        def hdiag(q):
            return ref.hess_diag(q, data, self.sizes)

        chk = self.sizes["check"]
        return check.readings(self.records, lpg, hdiag, chk["accept_target"],
                              self.collect, self.collect is None,
                              chk["replay_iters"], low if control else None)


def window(cell: Cell, probes: Probes, seconds: float, trace: bool):
    """Fits back to back for `seconds`: (fits, activity or None).  With
    `trace` the fits run under torch.profiler, tracing the device's
    operations and the CUDA runtime's calls, not the host's operators:
    those cost warmup's eager loop up to half its time.  What the check
    keeps of each fit is taken after the window, so the device does no
    work of the benchmark's inside it."""
    import torch

    prof = None
    if trace:
        cuda = torch.device(cell.device).type == "cuda"
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU])
        prof.start()
    fits, kept = [], []
    t0 = time.perf_counter()
    while True:
        wall, tr = cell.fit(probes, cell.traffic["warmup"],
                            cell.traffic["draws"])
        end = time.perf_counter() - t0
        counted = end <= seconds or not fits
        fits.append(Fit(wall, dict(tr.timings), None, counted))
        kept.append((tr, probes.kernel, probes.warm))
        if end + wall > seconds:
            break
    activity = None
    if prof is not None:
        prof.stop()
        from portbench.profile import Activity

        activity = Activity.from_profiler(prof, sum(f.wall for f in fits),
                                          len(fits))
    for fit, (tr, kernel, warm) in zip(fits, kept):
        fit.draws = tr.chains
        if fit.counted:
            probes.kernel, probes.warm = kernel, warm
            cell.record(probes, tr, fit.draws)
    return fits, activity


class Run:
    """What a metric's reader sees: the set-up seconds, the counted fits,
    the traffic, the sizes, the work count, the card's peaks and, traced,
    the device's activity."""

    def __init__(self, setup_s, fits, cell: Cell, peaks, activity):
        self.setup_s = setup_s
        self.fits = [f for f in fits if f.counted]
        self.traffic = cell.traffic
        self.sizes = cell.sizes
        self.work = cell.cfg.ref.work(cell.sizes)
        self.n_collect = cell.dim if cell.collect is None \
            else len(cell.collect)
        self.peaks = peaks
        self.activity = activity
        self.notes = {}
        self._ess = {}

    def timing(self, key: str):
        """The mean over the counted fits of the program's
        ``Trace.timings[key]``, or None where it has none."""
        vals = [f.timings[key] for f in self.fits if key in f.timings]
        return sum(vals) / len(vals) if vals else None

    def ess_min(self, i: int) -> float:
        """Fit i's least bulk ESS over its coordinates."""
        if i not in self._ess:
            from portbench.ess import bulk_ess

            self._ess[i] = float(bulk_ess(self.fits[i].draws).min())
        return self._ess[i]


def device_info(device, count):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, root: Path = ROOT, sizes=None, traffic=None,
             t_start=None, base: Path = BASE):
    """One run of one cell: (result dict, lines of the numbers compared).
    `sizes` and `traffic` override the cell's (tests run small cells on
    the CPU)."""
    import torch
    from portbench import manifest, peaks as P

    t_start = T_START if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(workload, seed, device, root, sizes, base, traffic)
    with Probes(cell.density) as probes:
        cell.fit(probes, *SETUP_FIT)
        setup_s = time.perf_counter() - t_start
        fits, activity = window(cell, probes, seconds, trace)
    dev_info = device_info(device, cell.cell["chips"])
    failed = sum(not math.isfinite(float(abs(f.draws).sum()))
                 for f in fits if f.counted)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.readings()["program"]
    limits = cell.sizes["limits"]
    # every number the configuration limits has to be read: one that is
    # missing (warmup's density evaluated past the probe) fails the run
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    correct = failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    run = Run(setup_s, fits, cell, P.peaks(dev_info["kind"]), activity)
    metrics = {}
    for m in manifest.metrics(cell.bench, workload, trace):
        value = manifest.reader(m["name"], base).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(run.fits),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if activity is not None:
        busy, _ = activity.busy()
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = activity.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in activity.top_ops()],
            "idle_gaps": [[n, s] for n, s in activity.top_gaps()]}
    result["fits_s"] = [f.wall for f in fits]
    result.update(run.notes)
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             if c["value"] is not None else
             f"check {k}: missing, the run read no such number "
             f"(limit {c['limit']!r})" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(ROOT)
    # one process with one thread of host compute: no pool of idle threads
    # competes with the fits' host loop
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if not (ROOT / "rainier_tpu_torch").is_dir():
        print("the program (rainier_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch
    from portbench import manifest

    torch.set_num_threads(1)
    chips = manifest.workload(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    print(f"fits {len(result['fits_s'])}, counted {result['attempted']}: "
          + " ".join(f"{s:.4f}" for s in result["fits_s"]), file=sys.stderr)
    # last, once the reference and every metric's reader have loaded
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
