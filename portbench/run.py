#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix, read from ``portbench/configs`` and ``portbench/traffic``; the
mix names its kind of loop (``portbench/loops``). The run makes its data
from the seed, builds the port's model, warms up the loop's own shapes
(set-up, ``setup_s``), then runs whole units of the traffic until
``--seconds`` have passed (the window). ``--trace 0``
reports the cell's end-to-end metrics, with nothing traced; ``--trace 1``
traces the window with ``torch.profiler`` and reports the per-layer metrics
(``portbench/metrics``), the device's busy seconds and a breakdown. Either
way the run then frees the model and the loop's judge holds what the window
produced to the plain reference (``portbench/reference``), each number
against its limit
(``portbench/limits/<cell>.json``): the last lines on standard error, the
last key of the result. The result is the last line of standard output.

``--control``: also print the numbers of the control (the reference in the
cell's lower precision in the program's place) and of planted faults: the
readings the limits were set from.

The run needs CUDA with as many cards as the cell asks for; without them it
exits with an error and prints no result. It also fails, with no result, if
JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "manifold_gp_tpu")
# caches the libraries may write, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def process_age() -> float:
    """Seconds since this process started (its start time from /proc; the
    time since this module began where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, control: bool = False,
             setup_clock=process_age) -> dict:
    """One run of ``cell`` on ``device``: the result's fields, with the
    checks as (correct, rows) under "verdict" and, with ``control``, the
    control's numbers under "control"."""
    import torch

    from portbench.harness import check, program, spec
    from portbench.harness.readers import Run
    from portbench.harness.trace import Profiler

    config, traffic = cell.config, cell.traffic
    spans = {}
    model, inputs = program.build(config, seed, device, spans)
    kind = spec.loop_kind(traffic["loop"])
    loop = kind.Loop(model, cell, seed, inputs)
    loop.warm_up()
    program.sync(device)
    setup_s = setup_clock()

    with Profiler(trace) as prof:
        work = loop.window(seconds)
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {', '.join(found)}")

    out = {"attempted": work["units"], "failed": work["failed"], "setup_s": setup_s,
           "window_s_host": work["window_s"], "counters": work["counters"]}
    units = cell.units
    if not trace:
        values = {"setup_s": setup_s, **work["end_to_end"]}
        missing = [m for m in cell.end_to_end if m not in values]
        if missing:
            raise RuntimeError(f"the {traffic['loop']} loop does not measure {missing}")
        out["metrics"] = {m: {"value": values[m], "unit": units[m]} for m in cell.end_to_end}
    else:
        summary = prof.summary(work["window_s"])
        run = Run(config=config, traffic=traffic, spans=spans, units=work["units"],
                  counters=work["counters"], layout=program.layout_spec(model),
                  device_name=torch.cuda.get_device_name(device) if cuda else "cpu",
                  trace=summary)
        metrics = {}
        for name in cell.per_layer:
            value = spec.metric_reader(name)(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        out["metrics"] = metrics
        out["busy_s"], out["window_s"] = summary.busy_s, summary.window_s
        out["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_by_host_op}
        del prof, summary, run
    out["memory_peak_bytes"] = memory_peak

    # What the window produced, then the program's state freed.
    record = loop.record()
    del model, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = check.reference_setup(inputs.train_x_raw, config["k"], device)
    numbers = kind.judge(ref, record, cell, inputs, seed, device)
    out["reference_s"] = time.perf_counter() - t_ref
    if control:
        out["control"] = kind.control(ref, record, cell, inputs, seed, device)
    limits = cell.limits["limits"]
    out["verdict"] = check.verdict(numbers, limits)
    out["unlimited"] = {k: v for k, v in numbers.items() if k not in limits}
    out["check_s"] = time.perf_counter() - t_ref
    return out


def _finite(value) -> bool:
    return value is None or math.isfinite(value)


def result_line(out: dict, dev: dict) -> tuple:
    """(the result's JSON object, the standard-error lines that end the run)
    from ``run_cell``'s fields and the device's name and count."""
    correct, rows = out["verdict"]
    lines = [f"portbench: setup_s {out['setup_s']!r} window_s {out['window_s_host']!r} "
             f"reference_s {out['reference_s']!r} check_s {out['check_s']!r} "
             f"launches {out['counters']!r} over {out['attempted']} units"]
    lines += [f"{kind} {name} = {value!r}" for kind, numbers in out.get("control", {}).items()
              for name, value in numbers.items()]
    lines += [f"reported {name} = {value!r} (not compared)"
              for name, value in out["unlimited"].items()]
    lines += [f"check {name} = {value!r} ({sense} {bound!r})" for name, value, bound, sense in rows]
    dev = {**dev, "memory_peak_bytes": out["memory_peak_bytes"]}
    if "busy_s" in out:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": bool(correct and out["failed"] == 0), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": dev}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    if "control" in out:
        result["control"] = out["control"]
    result["checks"] = {name: {"value": value if _finite(value) else repr(value), "limit": bound,
                               "sense": sense}
                        for name, value, bound, sense in rows}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(REPO / "portbench" / ".cache" / sub)
    sys.path.insert(0, str(REPO))
    import torch

    from portbench.harness import spec

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   control=args.control)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips}
    result, lines = result_line(out, dev)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
