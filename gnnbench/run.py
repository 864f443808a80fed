"""Run one cell of the benchmark once and print its result line.

    python -m gnnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the last lines of standard error are the same numbers. The run needs a
CUDA card and exits with another code than 0, printing no result, without
one, or if JAX or the JAX package was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "efficient_gnns_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``efficient_gnns_tpu_torch`` is not ``efficient_gnns_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from gnnbench import harness
    from gnnbench.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"gnnbench: {args.workload} needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    lines = result.pop("_lines")
    result.pop("_numbers")
    found = forbidden_modules()
    if found:
        print(f"gnnbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
