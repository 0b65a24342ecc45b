"""Runs one benchmark cell once and prints its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration; its traffic
file (portbench/workloads/<cell>.json) names the driver
(portbench/drivers/<driver>.py) and its parameters. Set-up builds the
port's model holding weights drawn from the seed, warms up the cell's
shapes and opens the window; the driver measures for `--seconds` seconds
of work, then the plain reference checks a sample of what the window
produced. `--trace 0` prints the cell's end-to-end metrics, `--trace 1`
its per-layer metrics (portbench/metrics/<metric>.py), read from the
harness's spans and a torch.profiler trace of the first units.

Needs as many CUDA devices as the cell asks for; without them it exits
with code 3 and prints no result. It exits with code 4, and prints no
result, if the JAX package or JAX itself is loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sam2_opt_tpu")


def _environment():
    """The configuration's routes, not a caller's: the port's switches are
    dropped; libraries keep away from JAX; caches stay in the checkout."""
    for key in list(os.environ):
        if key.startswith("SAM2_TPU_") or key == "SAM2_VERSION_TRACK":
            del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "inductor")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell's files, the seed, the window, and the
    places it reports to."""

    def __init__(self, args, config, traffic, device, t_start):
        from portbench.harness.window import Window

        self.seed, self.trace, self.control = args.seed, bool(args.trace), args.control
        self.seconds, self.config, self.traffic, self.device = args.seconds, config, traffic, device
        self.t_start = t_start
        self._sync = (lambda: __import__("torch").cuda.synchronize(device)) \
            if device.type == "cuda" else (lambda: None)
        self._Window = Window
        self.window = None
        self.metrics, self.readings = {}, {}
        self.attempted, self.failed, self.checked = 0, 0, 0
        self.setup_s = self.memory_peak = None
        self._prof, self._prof_done, self.traced_units = None, False, []

    def scratch_window(self):
        return self._Window(math.inf, self._sync)

    def start_window(self):
        self._sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.window = self._Window(self.seconds, self._sync)
        return self.window

    @contextlib.contextmanager
    def profiler(self, traced: bool):
        """Around one unit: a traced unit runs under the profiler (started
        at the first, stopped before the first untraced unit after it)."""
        from portbench.harness.trace import Profiler

        if traced and self._prof is None:
            self._prof = Profiler(self._sync, self.device.type == "cuda").__enter__()
        elif not traced and self._prof is not None and not self._prof_done:
            self._stop_profiler()
        yield
        if traced:
            u = self.window.units[-1]
            self._prof.units.append((u.t0, u.t1))
            self.traced_units.append(u.index)

    def _stop_profiler(self):
        self._prof.__exit__(None, None, None)
        self._prof_done = True

    def end_window(self):
        self._sync()
        if self._prof is not None and not self._prof_done:
            self._stop_profiler()

    def mark(self, stage: str):
        """Set-up split: seconds since the process started, printed."""
        self.note(f"set-up {stage}: {time.perf_counter() - self.t_start:.3f} s")

    def metric(self, name: str, value: float):
        self.metrics[name] = float(value)

    def note(self, text: str):
        print(f"portbench: {text}", file=sys.stderr, flush=True)

    def read_memory_peak(self):
        import torch

        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)

    def compared(self, readings, checked: int):
        self.readings, self.checked = dict(readings.values), checked
        for name, label in readings.worst.items():
            self.note(f"worst {name}: {label}")


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None, root: Path = ROOT, bench: Path = None, device=None) -> int:
    """Runs the cell; returns the exit code. Tests pass `device="cpu"` (and
    a `root` / `bench` holding their own files) to drive a run without a
    card."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8",), default=None,
                   help="the comparison's control, never part of a measurement: the "
                        "reference with its products' inputs rounded to fp8 in the port's place")
    args = p.parse_args(argv)
    _environment()
    import torch

    from portbench.harness import registry as reg

    registry = reg.Registry(root, bench or reg.PORTBENCH)
    cell = registry.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 3
        device = "cuda:0"
    device = torch.device(device)
    config, traffic = registry.config(cell["config"]), registry.traffic(args.workload)
    ctx = Context(args, config, traffic, device, T_START)
    ctx.mark("imports")
    torch.zeros(1, device=device)
    ctx.mark("device context")
    registry.driver(traffic["driver"]).run(ctx)

    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4

    result_metrics, breakdown, dev = {}, None, {}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": int(ctx.memory_peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if args.trace:
        from portbench.harness.readers import RunView

        trace = ctx._prof.read(ctx.window.spans) if ctx._prof is not None else None
        view = RunView(ctx, trace)
        for m in registry.per_layer(args.workload):
            value = registry.reader(m["name"])(view)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace is not None:
            dev["busy_s"], dev["window_s"] = trace.busy_seconds(), trace.window_seconds()
            breakdown = {"device_ops": [list(x) for x in trace.top_ops()],
                         "idle_gaps": [list(x) for x in trace.idle_gaps()]}
            ctx.note(f"traced {len(ctx.traced_units)} unit(s): {ctx.traced_units}")
    else:
        ctx.metric("setup_s", ctx.setup_s)
        for m in registry.end_to_end(args.workload):
            result_metrics[m["name"]] = {"value": ctx.metrics[m["name"]], "unit": m["unit"]}

    limits = traffic["limits"]
    checks = {name: {"value": ctx.readings.get(name), "limit": limit}
              for name, limit in limits.items()}
    correct = all(c["value"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    info = {k: v for k, v in ctx.readings.items() if k not in limits}
    print(f"portbench: {args.workload} seed {args.seed}: {ctx.attempted} units, "
          f"{ctx.checked} checked; device {dev['kind']}, power limit {_power_limit()}; "
          f"readings without a limit {json.dumps(info)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
            "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
