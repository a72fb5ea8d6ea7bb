"""Run one cell of the benchmark and print its result line.

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration (`configs/<config>.json`) and a traffic
mix (`traffic/<mix>.json`), whose kind (`kinds/<kind>.py`) drives the
program's entry; the configuration names its plain reference
(`reference/<name>.py`), and the per-layer metrics are the readers
`metrics/<metric>.py`. The run builds the calculator, warms up the cell's
shapes on a job of its own, then runs jobs back to back until `--seconds`
have passed and the job in progress has ended. With `--trace 0` it prints
the cell's end-to-end metrics; with `--trace 1` it traces the card over the
first jobs (at least TRACE_SECONDS) and prints the per-layer metrics. Every
run then compares a sample of the window's answers with the plain reference
(`check.py`) and prints each number compared beside its limit, on standard
error and last in the result line.

The run exits with code 2 and prints no result without the CUDA cards the
cell asks for, and with code 3 when JAX or the JAX package was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
TRACE_SECONDS = 3.0
FORBIDDEN = ("jax", "jaxlib", "flax", "multioptpy_tpu")


def _environment():
    """Kernel caches at fixed paths inside the checkout; few host threads."""
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def loaded_forbidden():
    """Top-level names of JAX and the JAX package among sys.modules,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(root, name):
    """(benchmark spec, cell, configuration, mix) of the cell `name`."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / spec["paths"][0] / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return spec, cell, config, mix


def cell_metrics(spec, cell, trace):
    """The metric entries this cell reports: its end-to-end metrics, or with
    `trace` its per-layer metrics."""
    e2e = [m for m in spec["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(root, spec, metric):
    """The `read(name, run)` of a per-layer metric: metrics/<stem>.py, the
    stem being the name up to its first dot (one reader serves `.single`
    and `.batch`)."""
    stem = metric.split(".")[0]
    path = root / spec["paths"][0] / "metrics" / f"{stem}.py"
    if not path.exists():
        raise SystemExit(f"no reader for the metric {metric!r}: {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"gpu_bench_metric_{stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(root, name, seed, seconds, trace, device=None, dtype=None):
    """Run the cell and return (result dict, stderr lines). `device` and
    `dtype` (a torch dtype) replace the card and the configuration's
    precision: the tests run the harness on the CPU, and the lower-precision
    control through it."""
    import numpy as np
    import torch

    from gpu_bench import check
    from gpu_bench.generate import Traffic
    from gpu_bench.spans import SpanCalc
    from gpu_bench.trace import Trace, summarize

    spec, cell, config, mix = load_cell(root, name)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"no result: {name} needs {cell['chips']} CUDA card(s)",
                  file=sys.stderr)
            raise SystemExit(2)
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    cuda = device == "cuda"
    if trace and not cuda:
        raise SystemExit("a traced run needs the card")
    torch.set_num_threads(1)

    from multioptpy_tpu_torch.calculators.base import get_calculator
    from multioptpy_tpu_torch.drivers.optimize import OptimizeConfig

    dtype = dtype or getattr(torch, config["dtype"])
    calc_kw = dict(config["calculator"])
    calc = SpanCalc(get_calculator(calc_kw.pop("name"), device=device,
                                   **calc_kw), timed=bool(trace))
    traffic = Traffic(config, mix, seed)
    z = traffic.z
    batch = traffic.batched
    ctx = SimpleNamespace(
        calc=calc, z=z, mix=mix, device=device,
        optimizer=dict(config["optimizer"]),
        opt_cfg=OptimizeConfig(**config["optimizer"]),
        dissociation_limit=config["dissociation_limit_ang"] / 0.52917721067)

    def run_job(j, steps=None):
        x = torch.as_tensor(traffic.job(j), dtype=dtype, device=device)
        calc.begin_job()
        return traffic.kind.run(ctx, x, steps)

    run_job(-1, steps=2)                              # warm-up
    calc.jobs.clear()
    calc.gradients, calc.span_s, calc.spans_ns = 0, 0.0, []
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    results, steps, step_s, jobs_ns = [], [], [], []
    limit = min(seconds, TRACE_SECONDS) if trace else seconds
    tracer = Trace() if trace else None
    if tracer:
        tracer.__enter__()
    t0 = time.perf_counter()
    j = 0
    while j == 0 or time.perf_counter() - t0 < limit:
        w0 = time.time_ns()
        res, dts, n = run_job(j)
        jobs_ns.append((w0, time.time_ns()))
        results.append(res)
        steps.append(n)
        step_s += dts
        j += 1
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if tracer:
        tracer.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    b = mix["batch"] if batch else 1
    structure_steps = b * sum(steps)
    values = {"setup_s": setup_s}
    if batch:
        values["struct_steps_per_s"] = structure_steps / window_s
    else:
        values["step_ms"] = window_s * 1e3 / max(sum(steps), 1)
        if step_s:
            values["step_ms_p95"] = float(np.percentile(step_s, 95)) * 1e3
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": card,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": len(results) * b,
              "failed": sum(int((~torch.isfinite(r.energy)).sum())
                            for r in results)}
    metrics = {}
    breakdown = None
    if trace:
        summary = summarize(tracer.events(), tracer.window_s, calc.spans_ns,
                            jobs_ns)
        n_atoms = len(z)
        run = {"cell": name, "card": card, "steps": sum(steps),
               "structure_steps": structure_steps,
               "gradients": calc.gradients, "calc_s": calc.span_s,
               "itemsize": torch.empty((), dtype=dtype).element_size(),
               "dims": {"rfo": 3 * n_atoms,
                        "band": config["band_order"]},
               "trace": summary}
        for m in cell_metrics(spec, cell, True):
            v = reader(root, spec, m["name"])(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    else:
        for m in cell_metrics(spec, cell, False):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    # the comparison, after the window and the memory reading
    gaps = check.compare(calc.jobs, results, steps, config, seed, batch,
                         device)
    correct, checks = check.judge(gaps, config["limits"])
    result.update(correct=correct, metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"# {card}: {_card_line() if cuda else 'no card'}; "
             f"{len(results)} jobs, {sum(steps)} steps, window "
             f"{window_s:.3f} s, setup {setup_s:.3f} s"]
    if step_s:
        q = np.percentile(step_s, [10, 50, 90, 99, 100]) * 1e3
        lines.append("# step ms p10 p50 p90 p99 max: "
                     + " ".join(f"{v:.2f}" for v in q))
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in checks.items()]
    return result, lines


def main(argv=None):
    _environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    result, lines = run_cell(Path.cwd(), args.workload, args.seed,
                             args.seconds, args.trace)
    found = loaded_forbidden()
    if found:
        print(f"no result: loaded {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
