"""The control of ``correct``: the plain reference put in the program's
place and computed in int16, the next integer width below the int32 cells
the configuration states (the step a faster kernel would be tempted by),
judged by the benchmark's own comparison against the int32 reference, on
the cell's own pair size, one seed after another.  The benchmark's runs do
not run it.

    python3 -m masabench.control --config masabench/configs/cp1m-cli.json \\
        --seeds 11,12,13

One line per seed: the control's answer, the exact one, the numbers
compared and whether the control passed (it must not)."""

from __future__ import annotations

import argparse
import json
import time

import torch

from masabench import check, pairs, reference, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cfg = run.load_json(args.config)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        s0, s1 = pairs.draw(seed, cfg["pair"])  # a run's first pair
        t = time.perf_counter()
        exact = reference.sw_best(s0, s1, cfg, device=dev)
        t16 = time.perf_counter()
        got = reference.sw_best(s0, s1, cfg, device=dev, dtype=torch.int16)
        t1 = time.perf_counter()
        worst, failed = check.judge([{"scores": [got[0]], "ends": [got[1:]]}],
                                    [(s0, s1)], cfg, 0, exact)
        print(json.dumps({"seed": seed, "device": dev, "exact": exact,
                          "int16": got, "checks": worst,
                          "control_passed": failed == 0,
                          "seconds": [t16 - t, t1 - t16]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
