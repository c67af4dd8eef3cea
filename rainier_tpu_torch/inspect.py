"""Compiled-program and graph inspection (port of rainier_tpu/inspect.py).

Counterpart of rainier-decompile (CFR decompilation of generated bytecode,
rainier-decompile/.../Decompiler.scala:15-26) and the RealViz/BoundsViz
GraphViz dumps (compute/RealViz.scala).  The JAX package shows the stages
of its XLA program; the port's stages are those of what it runs:

* `graph(model)`  — the eager density's logp+grad as the aten operations
  PyTorch runs (``make_fx``), the counterpart of ``jaxpr``: what the scan
  path and the plain versions execute;
* `source(model)` — the C that ``compute/emit_cuda.py`` emits for the
  fused kernel (``rt_model.h``), the counterpart of ``hlo``: the program
  before the device compiler;
* `ptx(model)`    — the PTX that nvcc builds from ``csrc/fused_hmc.cu``
  and that header, the counterpart of ``optimized_hlo``: what runs on
  the card.  It needs nvcc and raises without it;
* `graphviz(real)` — DOT dump of the Real DAG, optionally annotated with
  static bounds (BoundsViz);
* `cost(model)`   — one density+gradient's f32 operations, bytes and
  transcendental calls as the emitter counts them (XLA's estimate in the
  JAX package): the roofline numerator ``chip_smoke.py`` uses;
* `trace(model, ...)` — a ``torch.profiler`` capture of a warm
  ``Model.sample``, written as a TensorBoard/Chrome trace.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile

import torch

from .compute import bounds as B
from .compute import emit_cuda
from .compute import real as R


def graph(model) -> str:
    """The aten graph of logp+grad at q = 0 on the CPU (``make_fx`` of
    the eager density and its autograd gradient)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    cd = model.density()
    cols = cd.column_values(torch.float32, "cpu")
    lpg = cd.logp_and_grad_fn()
    traced = make_fx(lambda q: lpg(q, cols))(torch.zeros(cd.n_vars))
    return traced.code


def source(model) -> str:
    """The emitted density header the fused kernel compiles."""
    return emit_cuda.emit(model.density()).source


def ptx(model, lanes: int | None = None, csrc=None) -> str:
    """PTX of the model's fused kernel for ``sm_90a``, built by nvcc from
    fused_hmc.cu in `csrc` (default the package's csrc/) and the emitted
    header as ``ops/fused_hmc.build`` builds the library (`lanes`: a
    model without rows' lanes a chain; default that of a 1024-chain
    launch).  Raises where there is no nvcc."""
    from .ops import fused_hmc as F

    csrc = F.CSRC if csrc is None else csrc
    em = emit_cuda.emit(model.density())
    lanes = lanes or F.lanes_per_chain(em, 1024)
    defines = () if em.spaces else (f"-DRT_LANES={lanes}",)
    nvcc = F._nvcc()
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, emit_cuda.HEADER_NAME), "w") as f:
            f.write(em.source)
        out = os.path.join(d, "fused_hmc.ptx")
        cmd = [nvcc, "-ptx", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", *defines, "-I", d, "-I", str(csrc),
               "-o", out, os.path.join(csrc, "fused_hmc.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr}\n{' '.join(cmd)}")
        with open(out) as f:
            return f.read()


# calls in the emitted text that the card's special-function units (or a
# series of them) evaluate
_TRANSCENDENTAL = re.compile(
    r"\b(?:expf|logf|log1pf|expm1f|sqrtf|sinf|cosf|tanf|asinf|acosf|atanf"
    r"|sinhf|coshf|tanhf|powf|lgammaf|rt_sigmoid|rt_softplus|rt_digamma)\(")


def cost(model) -> dict:
    """One density+gradient evaluation as the emitter counts it: "flops",
    the f32 operations over every row (``EmittedDensity.density_ops``)
    and of the pass over the rows' data-only terms (``const_ops``);
    "bytes accessed", every data column read once, q read and g written;
    "transcendentals", the calls in the emitted text, a row function's
    (and a row's data-only terms') counted once a row (a loop's body
    once)."""
    cd = model.density()
    em = emit_cuda.emit(cd)
    src = em.source
    rows = 0
    for s, tile in enumerate(em.spaces):
        names = ("rt_row(", "rt_row_const(") if len(em.spaces) == 1 \
            else (f"struct RtSpace<{s}>",)
        for name in names:
            if name not in src:
                continue
            start = src.index(name)
            body = src[start:src.index("\n}", start)]
            rows += tile.n_rows * len(_TRANSCENDENTAL.findall(body))
            src = src[:start] + src[src.index("\n}", start):]
    col_bytes = sum(4 * c.values.size for c in cd.columns)
    return {"flops": float(em.density_ops() + em.const_ops()),
            "bytes accessed": float(col_bytes + 4 * (2 * cd.n_vars + 1)),
            "transcendentals": float(rows
                                     + len(_TRANSCENDENTAL.findall(src)))}


def trace(model, config=None, log_dir: str | None = None,
          n_chains: int = 4, seed: int = 0, **kwargs) -> str:
    """Capture a profile of a short sampling run (the counterpart of the
    JAX package's ``jax.profiler`` trace, SURVEY §5): one run outside the
    capture builds and warms everything, the second runs under
    ``torch.profiler`` with CUDA activity where the run is on the card.
    Writes a TensorBoard-loadable trace directory (``tensorboard --logdir
    <dir>``, or the ``*.pt.trace.json`` in Perfetto or chrome://tracing)
    and returns its path.  `kwargs` go to ``Model.sample`` (``kernel=``,
    ``device=``); `log_dir` defaults to a new temporary directory."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from . import config as global_config
    from .sampler import SamplerConfig

    config = config or SamplerConfig(warmup_iterations=50, iterations=50)
    log_dir = log_dir or tempfile.mkdtemp(prefix="rainier_trace_")
    os.makedirs(log_dir, exist_ok=True)
    model.sample(config, n_chains=n_chains, seed=seed, **kwargs)
    device = torch.device(global_config.resolve_device(kwargs.get("device")))
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        model.sample(config, n_chains=n_chains, seed=seed, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return log_dir


def _node_label(node: R.Real, with_bounds: bool) -> str:
    if isinstance(node, R.Constant):
        lab = f"{node.value:g}"
    elif isinstance(node, R.Parameter):
        lab = f"θ{node.id}" + (f" ({node.name})" if node.name else "")
    elif isinstance(node, R.VectorParameter):
        lab = f"θ{node.id}[{node.k}]"
    elif isinstance(node, R.Column):
        lab = f"col[{node.n_rows}]"
    elif isinstance(node, R.IntColumn):
        lab = f"icol[{node.n_rows}]"
    elif isinstance(node, R.Unary):
        lab = node.op
    elif isinstance(node, R.Binary):
        lab = node.op
    elif isinstance(node, R.NArySum):
        lab = f"sum({len(node.children)})"
    elif isinstance(node, R.LogSumExp):
        lab = f"logsumexp({len(node.children)})"
    elif isinstance(node, R.Select):
        lab = f"select[{node.pred}]"
    elif isinstance(node, R.Compare):
        lab = "compare"
    elif isinstance(node, R.Lookup):
        lab = f"lookup({len(node.table)})"
    elif isinstance(node, R.Gather):
        lab = "gather"
    elif isinstance(node, R.RowSum):
        lab = f"rowsum[{node.n_rows}]"
    elif isinstance(node, R.VecSum):
        lab = f"vecsum[{node.k}]"
    else:
        lab = type(node).__name__
    if with_bounds:
        lo, hi = B.bounds_of(node)
        lab += f"\\n[{lo:.3g}, {hi:.3g}]"
    return lab


def graphviz(real, with_bounds: bool = False) -> str:
    """DOT source of the expression DAG (RealViz/BoundsViz analogue)."""
    real = R.to_real(real)
    lines = ["digraph Real {", "  node [shape=box, fontsize=10];"]
    for node in R.topological([real]):
        lines.append(
            f'  n{node.id} [label="{_node_label(node, with_bounds)}"];')
        for c in R.children_of(node):
            lines.append(f"  n{c.id} -> n{node.id};")
    lines.append("}")
    return "\n".join(lines)
