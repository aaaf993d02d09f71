"""The control of a cell's check, on the card: the plain reference of the
configuration's family (``reference/<family>.py``) put in the program's
place, computed in the next precision below the one the configuration
serves in (fp8 e4m3 operands of every matmul and conv, for bf16),
compared with the float32 reference by the check's own numbers.

    python3 benchmark/calibrate.py --workload <name> --seeds 11 12 13

For each seed it makes the weights and the traffic as a run does, takes
the cell's sample size of requests from its clients, judges the control's
images against the float32 reference's by the run's own comparison
(``harness.judge``) at the cell's limits, and prints one JSON line per
seed: ``correct``, the numbers compared beside their limits, and each
image's mean and largest gap in levels. It exits with 1 if the control
reads correct on any seed. The runs of the benchmark itself never run the
control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import family, harness, traffic, weights

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.cell_files(manifest, args.workload)
    harness.devices(int(cell["entry"]["chips"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, spec = cell["config"], cell["workload"]["check"]
    reference = family.reference(cfg)
    dtype = getattr(torch, cfg["serving"]["dtype"])
    passed = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        # the clients' first requests, then their second ...
        reqs = [r for ith in zip(*traffic.client_requests(cell["mix"], seed))
                for r in ith][:int(spec["sample"])]
        state = weights.make(cfg, seed, "cuda", dtype)
        block = int(spec.get("block", 1))
        ref = reference.Reference(cfg, state)
        ctl = reference.Reference(cfg, state, quant=reference.fp8_quant)
        means, maxes = [], []
        for b in range(0, len(reqs), block):
            part = reqs[b:b + block]
            want = ref.generate(part, "cuda")
            got = ctl.generate(part, "cuda")
            for g, w in zip(got, want):
                mean, most = harness.image_gaps(g, w)
                means.append(mean)
                maxes.append(most)
        compared, correct = harness.judge(means, maxes, spec["limits"])
        if correct:
            passed.append(seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "fp8_e4m3", "correct": correct,
                          "check": compared, "mean_gap": means,
                          "max_gap": maxes,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
        del state, ref, ctl
        torch.cuda.empty_cache()
    if passed:
        print(f"calibrate: the control reads correct on seeds {passed}: "
              "the limits do not separate it", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
