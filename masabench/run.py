"""One run of one cell of the benchmark of ``masa_tpu_torch`` on the card:

    python3 -m masabench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name: the cell in ``BENCHMARK.json``, the configuration in the file the
entry names, the traffic in ``masabench/traffic/<traffic>.json``, the
entry point in ``masabench/entries/<entry>.py`` and each metric's reader
in ``masabench/metrics/<metric>.py``.  A new cell, mix or metric is new
files and entries; no file here changes.

Set-up: import the port, build or load its kernels, draw the first pair
from the seed, and run one small pair through the same entry.  Then a
closed loop: one job at a time, back to back, the k-th pair drawn from
(seed, k); a new pair starts only while the window's clock is under
``--seconds``, and every started pair runs to its end.  The clock leaves
out the harness's work between pairs (reading the answer, deleting the
work directory, ``gc.collect`` and ``torch.cuda.empty_cache``, since a new
process holds nothing of an earlier pair and no cached device memory, and
drawing the next pair).  After the window, with the program's state
freed, the plain reference works out the optimum of one finished pair
drawn from the seed; that pair's answer is held to it, and every pair's
to itself and to its sequences (``check.py``).

The last line of standard output is the result, one JSON object; every
line before it starts with ``#``.  The numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
A run with no card, fewer cards than the cell asks for, or JAX or the JAX
package loaded when the window closes prints no result and exits 1."""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from masabench import check, pairs, reference

HERE = os.path.dirname(os.path.abspath(__file__))
# the modules a run may not hold: JAX and the JAX package, by top-level name
BANNED = ("jax", "jaxlib", "flax", "masa_tpu")
# the streams, beside the pairs' (seed, k >= 0), of the warm-up pair and of
# the draw of the pair whose optimum the reference works out
WARM_UP, SAMPLE = 1 << 40, (1 << 40) + 1


def say(text: str) -> None:
    print(f"# {text}", flush=True)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"masabench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix
    and metrics, found by name under ``root`` (the checkout)."""

    def __init__(self, bench: dict, name: str, root: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        cfg = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", f"{self.workload['traffic']}.json"))
        self.chips = self.workload["chips"]

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get("workloads", [name])]

        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])

    def metrics(self, trace: bool) -> list[dict]:
        return self.per_layer if trace else self.end_to_end


class Run:
    """One run's state: the pair, the entry, the answers, the timings and,
    when traced, the spans and the device's activity.  The metrics'
    readers read it."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, tmp: str):
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.config, self.traffic = cell.config, cell.traffic
        self.device, self.tmp = device, tmp
        self.pairs: list[tuple] = []  # (s0, s1) of each pair drawn
        self.answers: list[dict] = []
        self.cells = []          # m * n of each pair finished
        self.window_s = 0.0
        self.setup_s = None
        self.spans: list[dict] = []
        self.activity = None
        self.pair_peaks: list[int] = []  # device memory, bytes

    # -- what the readers read ------------------------------------------
    def stage_s(self, stage: str) -> list[float]:
        """The span's seconds of ``stage`` in each pair that ran it."""
        return [s["seconds"] for s in self.spans if s["stage"] == stage]

    def kernel_ms(self, stage: str, wrapper: str) -> list[float]:
        return [s["kernel_ms"].get(wrapper, 0.0) for s in self.spans
                if s["stage"] == stage]

    def cells_of(self, stage: str) -> int:
        """The m * n of the pairs that ran ``stage``."""
        return sum(len(s0) * len(s1) for s0, s1 in
                   (self.pairs[s["pair"]] for s in self.spans
                    if s["stage"] == stage))

    def launches(self, stage: str, wrapper: str) -> list[int]:
        return [s["launches"].get(wrapper, 0) for s in self.spans
                if s["stage"] == stage]

    @property
    def pairs_done(self) -> int:
        return len(self.cells)

    def pair(self, k: int) -> tuple:
        """The k-th pair of the run's seed, drawn once."""
        while len(self.pairs) <= k:
            self.pairs.append(pairs.draw(self.seed, self.config["pair"],
                                         len(self.pairs)))
        return self.pairs[k]


def _window(run: Run, entry, tracer) -> None:
    """The measured window: pairs back to back while the clock is under
    ``run.seconds``; the work between them is off the clock.  Each pair's
    peak of device memory lands in ``run.pair_peaks``."""
    cuda = run.device.type == "cuda"
    clock = 0.0
    while clock < run.seconds:
        k = len(run.answers)
        s0, s1 = run.pair(k)
        if cuda:
            torch.cuda.reset_peak_memory_stats(run.device)
        t0 = time.perf_counter()
        try:
            if tracer:
                with tracer.pair(k):
                    entry.pair(k)
                    if cuda:
                        torch.cuda.synchronize(run.device)
            else:
                entry.pair(k)
                if cuda:
                    torch.cuda.synchronize(run.device)
            dt = time.perf_counter() - t0
            run.cells.append(len(s0) * len(s1))
            ans = entry.collect(k)
        except Exception:
            dt = time.perf_counter() - t0
            ans = {"error": traceback.format_exc()}
            print(ans["error"], file=sys.stderr, flush=True)
        clock += dt
        run.answers.append(ans)
        # what a new process would not hold: the pair's objects (reference
        # cycles too) and the cached device memory
        gc.collect()
        if cuda:
            run.pair_peaks.append(torch.cuda.max_memory_allocated(run.device))
            torch.cuda.empty_cache()
        say(f"pair {k + 1}: {len(s0)} x {len(s1)} in {dt:.4f} s"
            + (f"; device memory peak {run.pair_peaks[-1]} bytes"
               if cuda else ""))
        if clock < run.seconds:
            entry.prepare(k + 1)
    run.window_s = clock


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None) -> tuple[dict, int]:
    """One run: the result's line as a dict, and the pairs whose answers
    failed.  ``t_start``: the perf_counter reading the set-up began at."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="masabench-")
    try:
        run = Run(cell, seed, seconds, trace, device, tmp)
        entry_mod = _load_module("entries", cell.config["entry"])
        if cuda:
            _build()
        entry = entry_mod.Entry(run)
        warm = dict(cell.config["pair"], m=cell.config["warmup_m"])
        entry.warm_up(*pairs.draw(seed, warm, WARM_UP))
        entry.prepare(0)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        run.setup_s = time.perf_counter() - t_start
        say(f"set-up {run.setup_s:.4f} s")
        tracer = None
        if trace:
            from masabench.trace import Tracer

            tracer = Tracer(entry.stages, device)
            tracer.start()
        try:
            _window(run, entry, tracer)
        finally:
            if tracer:
                tracer.stop()
        peak = max(run.pair_peaks, default=0)
        if tracer:
            run.spans = tracer.spans
            t = time.perf_counter()
            run.activity = tracer.device_activity()
            say(f"trace read in {time.perf_counter() - t:.1f} s")
            tracer = None
        entry.close()
        entry = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        worst, failed = {}, len(run.answers)
        done = [k for k, a in enumerate(run.answers) if "error" not in a]
        if done:
            sample = done[np.random.default_rng([SAMPLE, seed]).integers(
                len(done))]
            t = time.perf_counter()
            best = reference.sw_best(*run.pair(sample), cell.config,
                                     device=device)
            say(f"reference: pair {sample + 1}'s best {best[0]} at "
                f"({best[1]},{best[2]}) in {time.perf_counter() - t:.1f} s")
            worst, failed = check.judge(run.answers, run.pairs, cell.config,
                                        sample, best)
        metrics = {}
        for m in cell.metrics(trace):
            value = _load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": peak}
        if trace:
            dev["busy_s"] = run.activity["busy_s"] if run.activity else 0.0
            dev["window_s"] = (run.activity["window_s"] if run.activity
                               else run.window_s)
        attempted = len(run.answers)
        result = {"correct": attempted > 0 and failed == 0,
                  "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev}
        if run.activity:
            result["breakdown"] = run.activity["breakdown"]
        result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                            for k, v in worst.items()}
        return result, failed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _build() -> None:
    """Build or load what the card's path runs: the kernels (nvcc) and the
    native helpers (g++), all started together, into the port's own build
    directory inside the checkout."""
    import concurrent.futures

    from masa_tpu_torch.native import bindings
    from masa_tpu_torch.ops import kernels

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(kernels.build, k)
                for k in ("strip", "batched_strip", "hop")]
        futs.append(ex.submit(bindings.available))
        for f in futs:
            f.result()


def _disk_written() -> dict:
    """This process's bytes written: to storage (``write_bytes``) and
    passed to write() (``wchar``), from /proc."""
    try:
        with open("/proc/self/io") as fh:
            return {k: int(v) for k, v in
                    (line.split(": ") for line in fh)}
    except OSError:
        return {}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    io0 = _disk_written()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.getcwd()
    cell = Cell(load_json(os.path.join(root, "BENCHMARK.json")),
                args.workload, root)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"masabench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_start)
    held = sorted(k for k in sys.modules if k.split(".")[0] in BANNED)
    if held:
        print(f"masabench: the run loaded {held[:10]}", file=sys.stderr)
        return 1
    io1 = _disk_written()
    say("disk: " + json.dumps({k: io1[k] - io0.get(k, 0)
                               for k in ("write_bytes", "wchar")
                               if k in io1}) + " bytes written by this run")
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
