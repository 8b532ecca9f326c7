"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything else is found by name: its configuration's
file (``configs``' ``file``), its traffic mix ``portbench/workloads/
<traffic>.json``, whose ``kind`` names the module under ``portbench/kinds/``
that drives it, the plain reference ``portbench/reference/<family>.py`` the
configuration names, the limits of its comparison ``portbench/limits/
<cell>.json`` and one reader ``portbench/metrics/<metric>.py`` a per-layer
metric.  So a cell, a configuration or a metric is added by adding files.

With ``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones, read from a profile of a few steps
at the end of the window.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
(traced) ``breakdown``, and last ``checks``, each compared number beside its
limit, which also close standard error.  The run refuses, with no result
line, where there is no CUDA device, too few of them, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# build and kernel caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv", "PYTORCH_KERNEL_CACHE_PATH": "torch"}


def _setup_paths() -> None:
    if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
        sys.path.pop(0)          # no module here may shadow another
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench-cache" / sub)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def ours(m):
        return name in m.get("workloads", (name,))

    return {"name": name, "chips": cell["chips"],
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads(
                (HERE / "workloads" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads(
                (HERE / "limits" / f"{name}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if ours(m)],
            "per_layer": [m for m in bench["per_layer"] if ours(m)]}


def _reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a per-layer reader sees: the profile's summary (``trace``) and
    the cell's sizes."""

    def __init__(self, res: dict):
        self.trace, self.cell = res["trace"], res["cell"]


def measure(cell: dict, *, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None, plant=None) -> dict:
    """One run of ``cell``: the result line's object."""
    import torch

    family = importlib.import_module(
        f"portbench.reference.{cell['config']['family']}")
    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    res = kind.run(family, cell["config"], cell["traffic"], cell["limits"],
                   seed=seed, seconds=seconds, trace=trace, device=device,
                   t_start=T_START if t_start is None else t_start,
                   plant=plant)
    metrics = {}
    if trace:
        if not res["trace"] or not res["trace"]["kernels"]:
            raise RuntimeError("the profile holds no device kernel")
        ctx = Context(res)
        for m in cell["per_layer"]:
            v = _reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            v = res["end_to_end"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell["chips"], "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = res["trace"]["busy_s"]
        info["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = {
            "device_ops": [[k[:120], v] for k, v in
                           res["trace"]["device_by_name"][:10]],
            "idle_gaps": [[k, v] for k, v in
                          res["trace"]["idle_by_host"][:10]]}
    line["checks"] = res["checks"]
    return line


def loaded_forbidden(modules=None) -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = measure(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
