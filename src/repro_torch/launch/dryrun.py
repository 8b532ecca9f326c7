"""Dry run on the meta device: trace the port's steps for every
(architecture x input shape) and count their work on one H100, the
counterpart of the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each step on a 512-device fake TPU mesh
and reads XLA's cost and memory analyses.  The port has no compiler to ask:
it runs the step itself, on ``meta`` tensors (shapes and dtypes, no
memory, no values) under a ``TorchDispatchMode`` that sees every aten op,
and counts

* **FLOPs by dtype**: ``torch.utils.flop_counter``'s matmul-like ops (the
  step also runs under ``FlopCounterMode``, whose total must agree, and
  which is what the card counts on real tensors), plus each Hopper
  kernel's count from :mod:`repro_torch.kernels.cost`, which a wrapper
  given meta tensors reports instead of launching.  Elementwise operations
  are not counted (XLA's cost analysis counts them; the card's peaks are
  for matrix products);
* **bytes**: every op that is not a view or an allocation reads each input
  once and writes each output once (a broadcast input counts the elements
  it holds, a view its own); an in-place op reads and writes the tensor it
  changes (a fill or copy only writes it; an index write reads and writes
  the rows it touches); a gather reads the rows it gathers; the kernels'
  bytes come from :mod:`repro_torch.kernels.cost`;
* **peak live bytes**: the storages alive at once, each rounded up to the
  CUDA caching allocator's 512 bytes, from the first allocation of the
  trace (parameters, state, batch, cache) to the end of the step; a kernel
  wrapper's meta route allocates what its launch does, scratch included;
* **kernel calls** by name, and **the mix's bytes**: everything the step
  moves inside the engine's ``obs_mix`` ranges (the gossip kernels', or the
  gossip einsums').

A train shape traces ``init_state`` + ``warm_start`` and counts one
``step`` (the peak spans all three); prefill traces ``make_prefill_step``
on a fresh cache, decode ``make_serve_step`` on a ``seq_len`` cache.  With
``probe`` the counts come from probes cut to a few pattern units and are
extrapolated linearly in the units, as the reference does: the port loops
over its layers, so the units are identical subgraphs.  The probes have 2
and 3 units, where the reference's have 1 and 2: the first unit differs
from the others in which small tensors (a loss accumulator, 512 bytes)
are alive at the peak, so from 1 and 2 units the peak misses by one
allocation, while from 2 and 3 every count is exact.  The probes keep the
remainder layers, so nothing is pro-rated.

Data-dependent ops (``.item()``, ``nonzero``, boolean-mask indexing) fail
on meta: a row that fails to trace names the host sync that stopped it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 8] [--out experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import configs
from ..dist import steps as dsteps
from ..kernels import cost
from ..models import build, model as modellib

MESH = "1xH100"
ALLOC_ROUND = 512        # the CUDA caching allocator's rounding
MIX_RANGE = "obs_mix"    # the engine's record_function around every mix
PROBES = (2, 3)          # the probes' units (see the module docstring)


def _ops(*names) -> frozenset:
    """The aten overloads ``names`` (``"op.overload"``) this torch has."""
    out = []
    for name in names:
        op, overload = name.split(".")
        packet = getattr(torch.ops.aten, op)
        if overload in packet.overloads():
            out.append(getattr(packet, overload))
    return frozenset(out)


# allocations, markers and metadata: no bytes moved
_FREE = _ops("empty.memory_format", "empty_strided.default",
             "empty_like.default", "_unsafe_view.default",
             "lift_fresh.default", "detach.default", "alias.default",
             "set_.source_Storage_storage_offset", "resize_.default")
# in-place ops that overwrite the tensor they change without reading it
_OVERWRITE = _ops("copy_.default", "fill_.Scalar", "fill_.Tensor",
                  "zero_.default", "normal_.default", "uniform_.default",
                  "random_.default", "random_.from", "random_.to")
# in-place index writes: read and write the rows the values land in
_INDEX_WRITE = _ops("index_put_.default", "_index_put_impl_.default",
                    "index_copy_.default", "index_add_.default",
                    "scatter_.src", "scatter_add_.default")
# gathers: the data operand (the first) is read where gathered only
_GATHER = _ops("index.Tensor", "index_select.default", "gather.default",
               "embedding.default")


def config_for_shape(cfg, shape_name: str):
    """Shape-specific config adjustments: long_500k requires sub-quadratic
    attention -> enable the sliding-window variant (4096) on archs whose
    attention is otherwise full-causal.  SSM archs need nothing."""
    if shape_name == "long_500k" and cfg.num_heads and not cfg.window:
        return dataclasses.replace(cfg, window=4096)
    return cfg


def _probe_cfg(cfg, k_units: int):
    """``cfg`` cut to ``k_units`` pattern units, the remainder layers kept
    (and whisper's encoder cut to as many layers as its decoder); the
    configured ``q_chunk`` and ``scan_chunk`` are kept, so a probe traces
    the same ops per layer as the full config.  The port has no scan to
    unroll."""
    units, rem = cfg.units_and_rem
    repl = dict(num_layers=k_units * len(cfg.pattern) + rem)
    if cfg.encoder_layers:
        if cfg.encoder_layers != units:
            raise ValueError(f"{cfg.name}: {cfg.encoder_layers} encoder "
                             f"layers against {units} decoder units; the "
                             "probes scale both alike")
        repl["encoder_layers"] = k_units
    return dataclasses.replace(cfg, **repl)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` holds (a broadcast dimension,
    stride 0, counts once)."""
    if t.numel() == 0:
        return 0
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st) \
        * t.element_size()


def _tensors(items) -> list:
    """The tensors among ``items`` and the lists in it (an aten op's
    arguments, or its outputs)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


# (op, argument metadata) -> (its outputs' metadata, FLOPs, bytes): a meta
# kernel's result is a function of its inputs' shapes, strides and dtypes,
# and many of them run in Python; a step repeats the same ops node after
# node and layer after layer.  Only calls whose tensors are all on meta are
# kept (a hit rebuilds its outputs there).
_MEMO: dict = {}
_MEMO_OK: dict = {}


def _memo_key(func, args, kwargs):
    """A hashable key of ``func``'s call, or None where the call must run:
    an op that mutates or aliases its inputs, or an argument that is not
    a meta tensor, a scalar or a sequence of them."""
    ok = _MEMO_OK.get(func)
    if ok is None:
        schema = func._schema
        ok = _MEMO_OK[func] = not (schema.is_mutable or any(
            r.alias_info is not None for r in schema.returns))
    if not ok:
        return None
    try:
        key = (func, _meta(args), _meta(tuple(sorted(kwargs.items()))))
        hash(key)
    except TypeError:
        return None
    return key


def _aliases(args, outs) -> bool:
    """Whether an output shares its storage with an input."""
    ins = {id(t.untyped_storage()) for t in _tensors(args)}
    return any(id(t.untyped_storage()) in ins for t in outs)


def _meta(a):
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise TypeError("only calls on meta tensors are memoised")
        return (tuple(a.shape), a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_meta(x) for x in a)
    return a


class Trace(TorchDispatchMode, cost.Recorder):
    """The counts of every op run while open (see the module docstring).
    :meth:`restart` zeroes the counts (not the live bytes or the peak), so
    a step is counted apart from its set-up."""

    def __init__(self):
        TorchDispatchMode.__init__(self)
        cost.Recorder.__init__(self)
        self.live, self.live_bytes, self.peak = {}, 0, 0
        self._ranges = []
        self.restart()

    def restart(self) -> None:
        self.flops_by_dtype = Counter()
        self.flops_counted = 0
        self.kernel_calls = Counter()
        self.bytes = self.mix_bytes = 0

    def __enter__(self):
        cost.Recorder.__enter__(self)
        return TorchDispatchMode.__enter__(self)

    def __exit__(self, *exc):
        TorchDispatchMode.__exit__(self, *exc)
        cost.Recorder.__exit__(self, *exc)

    # kernel calls, reported by the wrappers' meta routes
    def charge(self, name: str, work: cost.Work) -> None:
        self.kernel_calls[name] += 1
        self.flops_by_dtype[work.dtype] += work.flops
        self._moved(work.bytes)

    def _moved(self, n: int) -> None:
        self.bytes += n
        if MIX_RANGE in self._ranges:
            self.mix_bytes += n

    def adopt(self, tree) -> None:
        """Count the storages of the tensors in ``tree`` (nested dicts,
        lists, tuples) as live, like those the trace allocates."""
        for t in _leaves(tree):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        # the weakref lives in ``live`` until its storage dies
        self.live[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live_bytes += n
        self.peak = max(self.peak, self.live_bytes)

    def _free(self, key) -> None:
        self.live_bytes -= self.live.pop(key)[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.profiler._record_function_enter_new.default:
            self._ranges.append(args[0])
        elif func is torch.ops.profiler._record_function_exit._RecordFunction:
            self._ranges.pop()
        key = _memo_key(func, args, kwargs)
        hit = _MEMO.get(key) if key is not None else None
        if hit is not None:
            kind, metas, flops, nbytes = hit
            outs = [torch.empty_strided(*m[:2], dtype=m[2], device="meta")
                    for m in metas]
            out = outs[0] if kind is torch.Tensor else kind(outs)
        else:
            out = func(*args, **kwargs)
            outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
            packet = func._overloadpacket
            flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                     if packet in flop_registry else 0)
            nbytes = (self._op_bytes(func, args, kwargs, outs)
                      if func not in _FREE and not func.is_view else 0)
            if key is not None and _aliases(args, outs):
                # an alias the schema does not declare (``_unsafe_view``)
                _MEMO_OK[func] = False
            elif key is not None and (isinstance(out, torch.Tensor) or (
                    isinstance(out, (list, tuple)) and len(outs) == len(out))):
                _MEMO[key] = (
                    torch.Tensor if isinstance(out, torch.Tensor)
                    else type(out),
                    [(tuple(t.shape), t.stride(), t.dtype) for t in outs],
                    flops, nbytes)
        for t in outs:
            self._track(t)
        if flops:
            dt = cost.dtype_name(_tensors(args)[0].dtype)
            self.flops_by_dtype[dt] += flops
            self.flops_counted += flops
        if nbytes:
            self._moved(nbytes)
        return out

    @staticmethod
    def _op_bytes(func, args, kwargs, outs) -> int:
        # an out= tensor is written, not read
        ins = _tensors(args) + _tensors(
            v for k, v in kwargs.items() if k != "out")
        if func in _OVERWRITE:
            return sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[0])
        if func in _INDEX_WRITE:
            # indices and values read, the touched rows read and written
            vals = _nbytes(ins[-1])
            return sum(_nbytes(t) for t in ins[1:]) + 2 * vals
        if func in _GATHER and outs:
            data = min(_nbytes(ins[0]), _nbytes(outs[0]))
            return data + sum(_nbytes(t) for t in ins[1:]) \
                + sum(_nbytes(t) for t in outs)
        # an in-place op's tensor is among both: read, then written
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def counts(self) -> dict:
        return {"flops_by_dtype": dict(self.flops_by_dtype),
                "flops_counted": self.flops_counted,
                "bytes": self.bytes, "mix_bytes": self.mix_bytes,
                "peak_bytes": self.peak,
                "kernel_calls": dict(self.kernel_calls)}


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return []


def _step_inputs(model, cfg, shape, *, nodes, R, batch, dtype):
    """The tensors a step starts from, on meta: a train shape's f32
    parameters (the runtime's, before ``init_state`` flattens them into the
    (n, D) state), its (n, R, b, ...) batch, b = batch // (nodes·R)
    sequences a node and round, and its window of gossip weights (2R, n, n)
    (center masks (2R, n) for ``'sun'``); a serve shape's parameters in
    the config's dtype with its batch and a fresh cache (prefill) or its
    token, cache and position (decode)."""
    if shape.kind == "train":
        b = max(1, batch // (nodes * R))
        tmpl = modellib.train_batch_template(cfg, b, shape.seq_len, dtype)
        bt = {k: t.new_empty((nodes, R) + tuple(t.shape))
              for k, t in tmpl.items()}
        return (model.empty(torch.float32, "meta"), bt)
    params = model.empty(dtype, "meta")
    if shape.kind == "prefill":
        return (params, modellib.train_batch_template(
            cfg, batch, shape.seq_len, dtype),
            model.init_cache(batch, shape.seq_len, dtype, "meta"))
    return (params,) + modellib.decode_templates(cfg, batch, shape.seq_len,
                                                 dtype)


def trace(cfg, shape, *, nodes: int = 16, R: int = 2, gamma: float = 1e-3,
          train_kwargs: dict | None = None, batch: int | None = None
          ) -> dict:
    """Counts of one step of ``cfg`` at ``shape`` (an InputShape), traced
    whole on meta at the config's depth.  The trace starts with the step's
    inputs in place (they count toward the peak), as a measurement on the
    card starts once they are drawn."""
    model = build(cfg)
    dtype = getattr(torch, cfg.dtype)
    batch = shape.global_batch if batch is None else batch
    inputs = list(_step_inputs(model, cfg, shape, nodes=nodes, R=R,
                               batch=batch, dtype=dtype))
    with Trace() as tr:
        tr.adopt(inputs)
        if shape.kind == "train":
            tkw = dict(train_kwargs or {})
            init_state, warm_start, step = dsteps.make_train_step(
                model, cfg, gamma=gamma, R=R, **tkw)
            wshape = ((2 * R, nodes) if tkw.get("gossip_impl") == "sun"
                      else (2 * R, nodes, nodes))
            weights = torch.empty(wshape, dtype=torch.float32, device="meta")
            bt = inputs[1]
            state = init_state(inputs.pop(0), nodes)
            state = warm_start(state, bt)
            tr.restart()
            out = step(state, bt, weights)
        elif shape.kind == "prefill":
            tr.restart()
            out = dsteps.make_prefill_step(model, cfg)(*inputs)
        else:
            tr.restart()
            out = dsteps.make_serve_step(model, cfg)(*inputs)
        del out
        return tr.counts()


def _extrapolate(c2: dict, c3: dict, scale: int) -> dict:
    """cost(units) = c2 + (c3 - c2)·(units - 2), key by key."""
    out = {}
    for k, v2 in c2.items():
        v3 = c3[k]
        if isinstance(v2, dict):
            out[k] = {key: v2.get(key, 0) + (v3.get(key, 0) - v2.get(key, 0))
                      * scale for key in sorted(set(v2) | set(v3))}
        else:
            out[k] = v2 + (v3 - v2) * scale
    return out


def lower_one(arch: str, shape_name: str, *, nodes: int = 16, R: int = 2,
              gamma: float = 1e-3, verbose: bool = True, probe: bool = True,
              cfg_transform=None, train_kwargs: dict | None = None,
              batch: int | None = None) -> dict:
    """Trace one (arch x shape) on meta and return its record.  ``nodes``
    (16, the reference's single-pod node count) and ``R`` shape a train
    step; ``batch`` overrides the shape's global batch, listed under
    ``reduced``; ``cfg_transform`` and ``train_kwargs`` select a variant
    (see :mod:`repro_torch.launch.hillclimb`).  With ``probe`` (and more
    than ``PROBES[1]`` units) the counts come from the 2- and 3-unit
    probes of :data:`PROBES`, extrapolated to the config's units."""
    cfg = config_for_shape(configs.get(arch), shape_name)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = configs.INPUT_SHAPES[shape_name]
    kw = dict(nodes=nodes, R=R, gamma=gamma, train_kwargs=train_kwargs,
              batch=batch)
    t0 = time.time()
    units = cfg.units_and_rem[0]
    probed = probe and units > PROBES[1]
    if probed:
        c = _extrapolate(*(trace(_probe_cfg(cfg, k), shape, **kw)
                           for k in PROBES), units - PROBES[0])
    else:
        c = trace(cfg, shape, **kw)
    used = shape.global_batch if batch is None else batch
    reduced = ([] if used == shape.global_batch else
               [f"global_batch {shape.global_batch} -> {used}"])
    flops = sum(c["flops_by_dtype"].values())
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH,
        "devices": 1,
        "nodes": nodes if shape.kind == "train" else None,
        "R": R if shape.kind == "train" else None,
        "batch": used,
        "reduced": reduced,
        "probe": probed,
        "use_pallas": cfg.use_pallas,
        "gossip_impl": ((train_kwargs or {}).get("gossip_impl", "dense")
                        if shape.kind == "train" else None),
        "trace_seconds": round(time.time() - t0, 2),
        "flops": flops,
        "flops_by_dtype": c["flops_by_dtype"],
        "flops_counted": c["flops_counted"],
        "bytes_accessed": c["bytes"],
        "memory": {"peak_bytes": c["peak_bytes"]},
        "mix": {"total_bytes": c["mix_bytes"]},
        "kernel_calls": c["kernel_calls"],
    }
    if verbose:
        print(json.dumps(result, indent=2))
    return result


def _worker(cfgs: list) -> None:
    """A spawned tracer: one thread, and the configs registered in the
    process that spawned it (those its caller registered at run time too)."""
    torch.set_num_threads(1)
    have = set(configs.names())
    for cfg in cfgs:
        if cfg.name not in have:
            configs.register(cfg)


def results(fn, items: list, jobs: int = 1, first=None):
    """Yield ``(item, fn(*item))``, or ``(item, the exception it raised)``,
    in the order of ``items``.  With ``jobs`` > 1 the calls run in that
    many spawned processes (``fn`` and the items must pickle) that know
    this process's registered configs, submitted with the items ``first``
    holds true for ahead of the rest (the long traces first, so that no
    worker starts one last)."""
    if jobs <= 1:
        for it in items:
            try:
                yield it, fn(*it)
            except Exception as e:  # noqa: BLE001  (the caller lists it)
                yield it, e
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    order = sorted(range(len(items)),
                   key=lambda i: not (first and first(items[i])))
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context(
            "spawn"), initializer=_worker,
            initargs=([configs.get(n) for n in configs.names()],)) as ex:
        futs = {i: ex.submit(fn, *items[i]) for i in order}
        for i, it in enumerate(items):
            try:
                yield it, futs[i].result()
            except Exception as e:  # noqa: BLE001
                yield it, e


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(configs.INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--R", type=int, default=2)
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the rows in this many processes")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = configs.names() if (args.all or not args.arch) else [args.arch]
    shapes = (list(configs.INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    os.makedirs(args.out, exist_ok=True)
    one = functools.partial(lower_one, nodes=args.nodes, R=args.R,
                            verbose=False, probe=not args.no_probe)
    rows = [(arch, shape) for arch in archs for shape in shapes]
    failures = []
    for (arch, shape), res in results(
            one, rows, args.jobs,
            first=lambda r: configs.INPUT_SHAPES[r[1]].kind == "train"):
        tag = f"{arch}_{shape}_{MESH}"
        if isinstance(res, Exception):
            failures.append(tag)
            print(f"FAIL {tag}: {type(res).__name__}: {str(res)[:200]}",
                  flush=True)
            continue
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=2)
        print(f"OK   {tag}: trace={res['trace_seconds']}s "
              f"flops={res['flops']:.3e} bytes={res['bytes_accessed']:.3e}"
              f" peak={res['memory']['peak_bytes']:.3e}B "
              f"mix={res['mix']['total_bytes']:.3e}B", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + "; ".join(failures))
    print("all dry-runs traced")


if __name__ == "__main__":
    main()
