"""Single-source decentralized update-rule engine, the port of the JAX
package's ``core/engine.py``.

An :class:`UpdateRule` names a rule's structure and one generic :func:`step`
interprets it, with the runtime's gossip and oracle bound in
:class:`EngineOps` (γ = stepsize, u = local-optimizer transform, Mix = the
step's gossip window, R = accumulation/consensus rounds):

============  =========================================================
``dsgd``      x ← Mix(x − γ·u(g(x)))                       [12]
``local_sgd`` x ← Mix(x) − γ·u(g(Mix(x)))        (FedAvg over a
              federated schedule: empty rounds ⇒ pure local steps)
``dsgt``      x ← Mix(x − γ·h);  h ← Mix(h + g − g⁻)        [40]
``mc_dsgt``   same, R gossip rounds per mix + R-sample grads (Alg. 1)
``gt_local``  x ← Mix(x) − γ·h;  h ← Mix(h) + g − g⁻   (DIGing-style
              tracking with local updates: x and h share ONE round)
``d2``        x ← Mix(2x − x⁻ − γ(g − g⁻))                  [35]
``personalized``  x ← P(ℓ)·(x − γ·u(g(x))) with P(ℓ) the loss-proximity
              reweighting of the round's support (row-stochastic only)
============  =========================================================

A rule may carry a :class:`~repro_torch.core.compress.CompressionConfig`:
every mix then goes through the runtime's compressed window ``cmix``, which
threads one error-feedback residual per gossiped stream (``EngineState.res``
= (res_x, res_h)), at full precision while ``k < warmup``.  With
``comm_interval`` k > 1 only every k-th step mixes (the others apply the
identity and launch nothing); with ``delay`` d > 0 each window mixes the
payload of d steps ago and only the correction lands on the fresh payload,
``out = (payload + Mix(stale)) − stale`` (``EngineState.buf``).  The
wrappers nest as the reference's: compression innermost, then the gate,
then the delay.  A delayed step issues all its windows first, before the
oracle, since they read only state from before the step; on CUDA tensors
they run on a side stream of the device, and each correction waits for its
own window only, so the mix may run beside the step's other work (the
overlap the reference leaves to XLA's scheduler;
:func:`repro_torch.obs.trace.overlap_report` proves per step that the mix
reads nothing of the step's gradient).

State tensors are node-stacked flat matrices, (n, D) each.  Unlike the JAX
engine, which is pure, :func:`step` updates ``x`` and ``h`` in place and
returns a state holding the same storage (the new oracle sample lands in
g_prev's buffer): at qwen1.5-0.5b's full width each is 7.4 GB, and a
functional update would hold two copies of each.  Callers must not reuse a
state they passed in.  Trackers stored in a lower precision (the runtime's
``cast_aux``, bf16) are updated in the gradient's precision and cast on
store, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from . import compress

ALGORITHMS = ("dsgd", "local_sgd", "dsgt", "mc_dsgt", "gt_local", "d2",
              "personalized")

# ---------------------------------------------------------------------------
# In-step observability scalars (repro_torch.obs): f32 device scalars the
# step returns beside its metrics, so recording a run adds no host sync.
# ---------------------------------------------------------------------------

# The metric vocabulary; the descriptions live in repro_torch.obs.metrics.
OBS_METRICS = ("grad_norm", "consensus", "mix_residual", "tracker_residual")

# Column chunk of the norms' temporaries: an f32 (n, cols) block of at most
# this many bytes.  A whole-state expression such as x − x̄ would allocate
# another (n, D) f32 state (7.4 GB at qwen1.5-0.5b's full width, 4 nodes).
OBS_CHUNK_BYTES = 1 << 28


def default_obs(rule: "UpdateRule") -> tuple:
    """The rule's metric set: every rule has a gradient, an iterate and a
    mix; only tracking rules carry a tracker."""
    if rule.kind == "tracking":
        return OBS_METRICS
    return tuple(m for m in OBS_METRICS if m != "tracker_residual")


def _column_chunks(mat: torch.Tensor):
    step = max(1, OBS_CHUNK_BYTES // (4 * mat.shape[0]))
    return (slice(a, a + step) for a in range(0, mat.shape[1], step))


def _norm(mat: torch.Tensor, term) -> torch.Tensor:
    """sqrt(Σ ||term(cols)||²) over the column chunks ``cols`` of the
    (n, D) ``mat``, in f32: ``term`` builds each chunk's temporary."""
    tot = torch.zeros((), dtype=torch.float32, device=mat.device)
    for c in _column_chunks(mat):
        tot += torch.square(term(c).float()).sum()
    return tot.sqrt()


def _node_mean(g: torch.Tensor) -> torch.Tensor:
    """The (D,) f32 node mean of ``g``, a column chunk at a time."""
    out = torch.empty(g.shape[1], dtype=torch.float32, device=g.device)
    for c in _column_chunks(g):
        out[c] = g[:, c].float().mean(dim=0)
    return out


# The open taint analysis of :func:`repro_torch.obs.trace.overlap_report`,
# which every annotated call hands its tensors to; None outside one.
_analysis = None


def _annotated(fn, name: str):
    """``fn`` inside ``torch.profiler.record_function(name)``, so a profile
    splits a step into its grad and mix device time (the reference's
    ``jax.named_scope`` tags); None stays None.  Under an overlap analysis
    the call's arguments and results go to it: a kernel the analysis
    cannot see still reads and writes them."""
    if fn is None:
        return None

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            out = fn(*args, **kwargs)
            if _analysis is not None:
                _analysis.call(name, args, out)
            return out
    return call


_SIDE = {}


def _side_stream(device: torch.device):
    """The one side stream of a CUDA ``device`` that a delayed step's
    windows run on, made at its first use."""
    side = _SIDE.get(device)
    if side is None:
        side = _SIDE[device] = torch.cuda.Stream(device)
    return side


class EngineState(NamedTuple):
    """``x`` (n, D) iterates; ``h`` the gradient tracker (tracking rules) or
    x^{k-1} (difference rules) and ``g_prev`` the previous oracle sample,
    set by :func:`warm_start` (None otherwise); ``k`` the round counter;
    ``res`` the error-feedback residuals (res_x, res_h) of a compressing
    rule (res_h None for rules without a tracker), None otherwise; ``opt``
    the local optimizer's state (None without one); ``buf`` the stale
    payloads of a delayed rule, (buf_x, buf_h), each a tuple of ``delay``
    (n, D) slots, oldest first (buf_h None for rules without a tracker, and
    until :func:`warm_start` seeds it), None when ``delay`` is 0.  The JAX
    package's field order is (x, h, g_prev, opt, k, res, buf); ``opt``
    comes after ``res`` here so that the port's earlier positional uses
    keep their meaning."""

    x: torch.Tensor
    h: Optional[torch.Tensor]
    g_prev: Optional[torch.Tensor]
    k: int
    res: Optional[tuple] = None
    opt: Any = None
    buf: Optional[tuple] = None

    @property
    def opt_state(self) -> Any:
        """The host layer's name for ``opt`` (the reference's AlgoState)."""
        return self.opt


def _identity_update(g, s):
    return g, s


class EngineOps(NamedTuple):
    """What a runtime provides for the generic step.

    mix(offset, rounds, x)
        Apply gossip rounds [offset, offset+rounds) of the step's window to
        the (n, D) matrix ``x``; may mix in place and return ``x``.
    grad(x, out=None) -> (metrics, g)
        One accumulated stochastic-oracle sample per node (Assumption 2),
        an (n, D) matrix, written into ``out`` when given (its old values
        are discarded); ``metrics`` is runtime-defined, and for a
        personalized rule the per-node (n,) loss vector.
    cmix(offset, rounds, x, res, on) -> (x, res)
        The compressed window for a rule that carries compression: like
        ``mix`` on the quantized payload, threading the stream's residual
        ``res``; ``on`` False (warmup) mixes at full precision and leaves
        ``res`` as it was.
    local_update(g, opt) -> (update, opt)
        The local-optimizer hook (None: the identity, the paper's rules).
    cast_aux(t)
        The storage cast of the tracker slots (None: the identity; the arch
        trainer's ``aux_dtype``).  Returns ``t`` itself when it casts
        nothing.
    pmix(offset, rounds, x, losses) -> x
        The personalized window (required when ``rule.personalized``): the
        rounds of ``mix`` with each round's weights reweighted by the
        per-node ``losses`` (:func:`personalized_weights`).
    """

    mix: Callable[[int, int, torch.Tensor], torch.Tensor]
    grad: Callable[..., Tuple[Any, torch.Tensor]]
    cmix: Optional[Callable] = None
    local_update: Optional[Callable] = None
    cast_aux: Optional[Callable] = None
    pmix: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """Declarative spec of one rule (the reference's fields).

    kind
        ``sgd`` (descend on the fresh gradient), ``tracking`` (descend on
        the tracker h) or ``difference`` (D²'s x/g difference update).
    mix_before_update
        False: x ← Mix(x − γu); True: x ← Mix(x) − γu (the federated
        placement: an ``empty`` round is a pure local step).
    correction_in_mix
        tracking only.  True: h ← Mix(h + g − g⁻); False: h ← Mix(h) + g −
        g⁻ (the correction stays local).
    shared_round
        tracking only.  True: x and h consume the same R-round window
        (weights_per_step = R); False: disjoint windows (2R).
    tracker_init
        ``mean``: h⁰ = node mean of g⁰ on every node (Algorithm 1);
        ``local``: h⁰ = g⁰ per node.
    compression
        Quantize every gossip payload (None = full precision).
    delay
        Stale-window gossip: d > 0 mixes the payload from d steps ago and
        folds the correction into the fresh one, out = (payload +
        Mix(stale)) − stale, so the node mean moves as in the synchronous
        path under doubly-stochastic windows.  0 builds no wrapper.
    comm_interval
        Mix on every k-th step only, the identity in between (a pure local
        update); under ``delay`` the stale slots still advance every step.
    personalized / tau
        sgd kind only: each step the window's weights are reweighted by
        per-node loss proximity, α_ij = W_ij·exp(−tau·|ℓ_i − ℓ_j|), rows
        renormalized (outside Assumption 3 by design).
    """

    name: str
    kind: str                          # 'sgd' | 'tracking' | 'difference'
    gamma: float
    R: int = 1
    compression: Optional[compress.CompressionConfig] = None
    delay: int = 0
    comm_interval: int = 1
    mix_before_update: bool = False
    correction_in_mix: bool = True
    shared_round: bool = False
    tracker_init: str = "mean"
    supports_local_opt: bool = True
    personalized: bool = False
    tau: float = 4.0

    def __post_init__(self):
        if self.kind not in ("sgd", "tracking", "difference"):
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if self.personalized and self.kind != "sgd":
            raise ValueError("personalized reweighting is defined for the "
                             "sgd kind only")
        if self.personalized and (self.compression is not None or self.delay
                                  or self.comm_interval > 1):
            raise ValueError(
                "personalized weights are computed in-jit from this step's "
                "losses and cannot be combined with compression, delayed "
                "gossip, or comm_interval gating")
        if self.kind == "difference" and self.R != 1:
            raise ValueError("difference rules take one oracle sample/step")
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay}")
        if self.comm_interval < 1:
            raise ValueError(
                f"comm_interval must be >= 1, got {self.comm_interval}")
        if self.comm_interval > 1 and self.compression is not None:
            raise ValueError(
                "comm_interval > 1 cannot be combined with gossip "
                "compression (the error-feedback residual update cannot "
                "be gated per step); run one or the other")

    @property
    def weights_per_step(self) -> int:
        """Gossip rounds one step consumes (the paper's budget accounting)."""
        if self.kind == "difference":
            return 1
        if self.kind == "tracking" and not self.shared_round:
            return 2 * self.R
        return self.R

    @property
    def uses_tracker(self) -> bool:
        return self.kind == "tracking"

    @property
    def uses_prev_grad(self) -> bool:
        return self.kind in ("tracking", "difference")


_SPECS = {
    "dsgd": dict(kind="sgd"),
    "local_sgd": dict(kind="sgd", mix_before_update=True),
    "dsgt": dict(kind="tracking", supports_local_opt=True),
    "mc_dsgt": dict(kind="tracking"),
    "gt_local": dict(kind="tracking", mix_before_update=True,
                     correction_in_mix=False, shared_round=True,
                     tracker_init="local"),
    "d2": dict(kind="difference", supports_local_opt=False),
    "personalized": dict(kind="sgd", personalized=True),
}


def make_rule(name: str, gamma: float, R: int = 1,
              compression: Optional[compress.CompressionConfig] = None,
              delay: int = 0, comm_interval: int = 1,
              tau: float = 4.0) -> UpdateRule:
    """The one registry, the reference's: d2 is forced to R = 1."""
    if name not in _SPECS:
        raise ValueError(f"unknown algo {name!r} (have {sorted(_SPECS)})")
    if name in ("dsgt", "d2") and R != 1:
        raise ValueError(f"{name} uses R=1 (MC-DSGT is the R-round variant)")
    return UpdateRule(name=name, gamma=gamma, R=(1 if name == "d2" else R),
                      compression=compression, delay=delay,
                      comm_interval=comm_interval, tau=tau, **_SPECS[name])


def personalized_weights(Ws: torch.Tensor, losses: torch.Tensor,
                         tau: float) -> torch.Tensor:
    """Loss-proximity reweighting of an (R, n, n) window: α_ij = W_ij ·
    exp(−tau·|ℓ_i − ℓ_j|), rows renormalized (row-stochastic by
    construction, generally not column-stochastic), in f32."""
    l = losses.to(torch.float32)
    sim = torch.exp(-tau * (l[:, None] - l[None, :]).abs())
    W = Ws.to(device=l.device, dtype=torch.float32) * sim[None]
    den = W.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    return W / den


def init_state(rule: UpdateRule, x0: torch.Tensor, *, opt_init=None,
               res_dtype=None) -> EngineState:
    """Fresh state at the (n, D) iterate ``x0``: h and g_prev wait for
    :func:`warm_start`; ``opt_init(x0)`` makes the local optimizer's state;
    a compressing rule gets zeroed residuals (``res_dtype``: the runtime's
    tracker storage dtype, as the reference stores them).  A delayed rule
    gets ``delay`` stale x slots, each its own copy of x⁰ (x is updated in
    place): with identical rows, Mix(x⁰) − x⁰ = 0, so the first ``delay``
    steps see no correction.  The tracker slots come with h⁰ in
    :func:`warm_start`."""
    res = (compress.init_residual(x0, rule.uses_tracker, dtype=res_dtype)
           if rule.compression is not None else None)
    opt = opt_init(x0) if opt_init is not None else None
    buf = ((tuple(x0.clone() for _ in range(rule.delay)), None)
           if rule.delay else None)
    return EngineState(x=x0, h=None, g_prev=None, k=0, res=res, opt=opt,
                       buf=buf)


def _correct(t: torch.Tensor, m: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    """The delayed window's output (t + m) − s in f32, in ``t``'s dtype: the
    reference's order of operations.  ``m`` (a tensor of the mix's own) is
    overwritten when all three are f32: m + t is t + m bit for bit."""
    f32 = torch.float32
    if t.dtype == m.dtype == s.dtype == f32:
        return m.add_(t).sub_(s)
    return (t.to(f32) + m.to(f32)).sub_(s.to(f32)).to(t.dtype)


def step(rule: UpdateRule, state: EngineState, ops: EngineOps,
         obs: tuple = ()) -> Tuple[EngineState, Any]:
    """One round of ``rule``: (new state, runtime metrics).  Consumes
    ``state``: its x and h (and residuals, optimizer state) are updated in
    place.

    ``obs`` names in-step scalars (:data:`OBS_METRICS`); when non-empty the
    second return value is ``(metrics, obs_dict)``, each scalar an f32
    device tensor placed as the reference places it: ``grad_norm`` =
    ||g||_F of this step's oracle sample, ``consensus`` = ||x − x̄||_F of
    the new iterate, ``mix_residual`` = ||post − pre||_F of the x stream's
    window, ``tracker_residual`` = ||mean h − mean g||_F before the
    tracker's storage cast (0 without a tracker).  Each is taken where its
    tensors are still alive, over column chunks (:data:`OBS_CHUNK_BYTES`);
    ``mix_residual`` needs a copy of the pre-mix payload, which the
    in-place mixers overwrite, and only it takes one.  The runtime's grad
    and mix run inside ``torch.profiler.record_function("obs_grad")`` and
    ``("obs_mix")``."""
    gamma, R = rule.gamma, rule.R
    comp = rule.compression
    obs = tuple(obs)
    for name in obs:
        if name not in OBS_METRICS:
            raise ValueError(f"unknown obs metric {name!r} "
                             f"(have {OBS_METRICS})")
    scal = {}
    ops = ops._replace(grad=_annotated(ops.grad, "obs_grad"),
                       mix=_annotated(ops.mix, "obs_mix"),
                       cmix=_annotated(ops.cmix, "obs_mix"),
                       pmix=_annotated(ops.pmix, "obs_mix"))
    local_update = ops.local_update or _identity_update
    cast_aux = ops.cast_aux or (lambda t: t)
    res = None
    if comp is not None:
        if ops.cmix is None:
            raise ValueError(f"rule {rule.name!r} carries compression but "
                             "the runtime provided no EngineOps.cmix")
        if state.res is None:
            raise ValueError("compression needs residual state: "
                             "init_state materializes EngineState.res")
        res = list(state.res)

    buf = None
    if rule.delay:
        if state.buf is None:
            raise ValueError("delay > 0 needs stale-payload buffers: "
                             "init_state materializes EngineState.buf")
        buf = [None if q is None else list(q) for q in state.buf]

    def done(metrics, *, h_obs=None, g_obs=None, g_mean=None, **kw):
        """The new state and the step's metrics; with ``obs``, the scalars
        left to take (``h_obs`` the tracker before its cast, ``g_obs`` or
        its node mean ``g_mean`` the sample)."""
        new = state._replace(k=state.k + 1,
                             res=None if res is None else tuple(res),
                             buf=state.buf if buf is None else tuple(
                                 None if q is None else tuple(q)
                                 for q in buf), **kw)
        if not obs:
            return new, metrics
        x = new.x
        if "consensus" in obs:
            scal["consensus"] = _norm(x, lambda c: x[:, c].float().sub(
                x[:, c].float().mean(dim=0, keepdim=True)))
        if "tracker_residual" in obs:
            scal["tracker_residual"] = (
                torch.zeros((), dtype=torch.float32, device=x.device)
                if h_obs is None else _norm(h_obs, lambda c: h_obs[
                    :, c].float().mean(dim=0) - (
                        g_mean[c] if g_obs is None
                        else g_obs[:, c].float().mean(dim=0))))
        return new, (metrics, {name: scal[name] for name in obs})

    def grad(x, out=None):
        metrics, g = ops.grad(x) if out is None else ops.grad(x, out)
        if "grad_norm" in obs:
            scal["grad_norm"] = _norm(g, lambda c: g[:, c])
        return metrics, g

    def window(stream, off, r, mat):
        """Mix window of ``stream`` (0 = x, 1 = h): compressed with that
        stream's residual when the rule compresses, at full precision while
        k < warmup; the identity on a step ``comm_interval`` skips (the
        gates are host bools, so a skipped step launches nothing)."""
        if state.k % rule.comm_interval:
            return mat
        if comp is None:
            return ops.mix(off, r, mat)
        mat, res[stream] = ops.cmix(off, r, mat, res[stream],
                                    state.k >= comp.warmup)
        return mat

    issued = {}

    def issue(*windows):
        """Under ``delay``: launch every window of the step, (stream,
        offset, rounds) each, now, on a copy of its stream's oldest slot
        (the slot is needed for the correction).  They read only state that
        existed before the step, so they go before the oracle; on CUDA
        tensors onto the device's side stream, which first waits for all
        work queued so far: the copies (taken on the current stream, all
        before the wait), the last step's slot writes, the staged weights.
        The caching allocator is told of every tensor used across the two
        streams: each copy is recorded on the side stream (a window that
        returns a new tensor drops its copy while the side stream may still
        read it), and a window's new result on the current stream, which
        frees it."""
        copies = [buf[stream][0].clone() for stream, _, _ in windows]
        side = None
        if state.x.is_cuda and not state.k % rule.comm_interval:
            main = torch.cuda.current_stream(state.x.device)
            side = _side_stream(state.x.device)
            side.wait_stream(main)
        for stream, off, r in windows:
            mat = copies.pop(0)
            if side is None:
                issued[stream] = (window(stream, off, r, mat), None)
                continue
            with torch.cuda.stream(side):
                out = window(stream, off, r, mat)
                done = torch.cuda.Event()
                done.record(side)
            mat.record_stream(side)
            if out is not mat:
                out.record_stream(main)
            issued[stream] = (out, done)

    def mix(stream, off, r, mat):
        """The window, or under ``delay`` the window :func:`issue` launched
        for ``stream`` (with these ``off`` and ``r``) on the oldest stale
        slot (waited for here, on the current stream)
        with the correction folded into ``mat``: the payload is copied into
        the slot it consumed (cast to the slot's dtype, the tracker storage
        cast), that slot becomes the newest, and the output is written
        into ``mat``'s storage, so the state keeps its tensors."""
        if buf is None:
            return window(stream, off, r, mat)
        mixed, done = issued.pop(stream)
        if done is not None:
            torch.cuda.current_stream(mat.device).wait_event(done)
        q = buf[stream]
        stale = q[0]
        out = _correct(mat, mixed, stale)
        stale.copy_(mat)
        buf[stream] = q[1:] + [stale]
        return mat.copy_(out)

    def x_window(fn, mat):
        """``fn(mat)``, the x stream's window; with ``mix_residual``
        requested, ||fn(mat) − mat||_F against a copy of ``mat`` taken
        first."""
        if "mix_residual" not in obs:
            return fn(mat)
        pre = mat.clone()
        out = fn(mat)
        scal["mix_residual"] = _norm(out, lambda c: out[:, c].float()
                                     - pre[:, c])
        return out

    h_off = 0 if rule.shared_round else R
    if buf is not None:
        issue(*((0, 0, R), (1, h_off, R))[:1 + rule.uses_tracker])

    if rule.kind == "sgd":
        if rule.personalized:
            # the oracle runs first: its per-node losses reweight the mix
            if ops.pmix is None:
                raise ValueError(f"rule {rule.name!r} is personalized but "
                                 "the runtime provided no EngineOps.pmix")
            metrics, g = grad(state.x)
            upd, opt = local_update(g, state.opt)
            x = x_window(lambda z: ops.pmix(0, rule.weights_per_step, z,
                                            metrics),
                         state.x.add_(upd, alpha=-gamma))
        elif rule.mix_before_update:
            x = x_window(lambda m: mix(0, 0, R, m), state.x)
            metrics, g = grad(x)
            upd, opt = local_update(g, state.opt)
            x = x.add_(upd, alpha=-gamma)
        else:
            metrics, g = grad(state.x)
            upd, opt = local_update(g, state.opt)
            z = state.x.add_(upd, alpha=-gamma)
            del g, upd    # the sample is spent: not held through the mix
            x = x_window(lambda m: mix(0, 0, R, m), z)
        return done(metrics, x=x, opt=opt)

    if rule.kind == "difference":
        if state.g_prev is None:
            raise ValueError("call warm_start first")
        metrics, g = grad(state.x)
        gp = cast_aux(g)
        # z = 2x − x⁻ − γ(g − g⁻) in x⁻'s buffer; g − g⁻ in g⁻'s buffer, or
        # in g's when g⁻ is stored cast (g then lives on in its cast copy)
        z = state.h.neg_().add_(state.x, alpha=2.0)
        diff = (state.g_prev.neg_().add_(g) if gp is g
                else g.sub_(state.g_prev))
        x = x_window(lambda m: mix(0, 0, 1, m), z.sub_(diff.mul_(gamma)))
        # x^{k-1} rides in the h slot, uncast to keep the difference exact
        return done(metrics, x=x, h=state.x, g_prev=gp)

    if state.h is None:
        raise ValueError("call warm_start first (h requires g at x0)")
    if rule.mix_before_update:
        # the mix first: adam's update, a new (n, D) tensor, then never
        # lives beside a mix that makes one (the dense einsum's product)
        x = x_window(lambda m: mix(0, 0, R, m), state.x)
        d, opt = local_update(state.h, state.opt)
        x = x.add_(d, alpha=-gamma)
    else:
        d, opt = local_update(state.h, state.opt)
        x = x_window(lambda m: mix(0, 0, R, m),
                     state.x.add_(d, alpha=-gamma))
    del d
    h = state.h if rule.correction_in_mix else mix(1, h_off, R, state.h)
    g_mean = None
    if state.g_prev.dtype == x.dtype:
        # h + g − g⁻ taken as (h − g⁻) + g: g⁻ leaves h before the new
        # sample overwrites g⁻'s buffer, so the step holds three (n, D)
        # tensors, not four
        h = h.sub_(state.g_prev)
        metrics, g = grad(x, state.g_prev)
        h = h.add_(g)
        gp = g
    else:
        # trackers stored cast: (h + g) − g⁻ in the gradient's precision,
        # in g's buffer once its cast copy is taken (and, for the tracker
        # residual, its (D,) node mean)
        metrics, g = grad(x)
        gp = cast_aux(g)
        if "tracker_residual" in obs:
            g_mean = _node_mean(g)
        h = g.add_(h).sub_(state.g_prev)
        g = None
    if rule.correction_in_mix:
        h = mix(1, h_off, R, h)
    return done(metrics, x=x, h=cast_aux(h), g_prev=gp, opt=opt, h_obs=h,
                g_obs=g, g_mean=g_mean)


def warm_start(rule: UpdateRule, state: EngineState,
               ops: EngineOps) -> EngineState:
    """Tracker/correction initialization, once per rule kind: sgd rules
    need none; difference rules set x⁻ = x⁰ (a copy, in the h slot) and g⁻
    = 0, so the first update is one DSGD step; tracking rules query the
    oracle at x⁰ and set h⁰ per ``rule.tracker_init`` (the node mean of g⁰
    on every node, or g⁰ itself), g⁻ = g⁰."""
    cast_aux = ops.cast_aux or (lambda t: t)
    if rule.kind == "sgd":
        return state
    if rule.kind == "difference":
        return state._replace(h=state.x.clone(),
                              g_prev=cast_aux(torch.zeros_like(state.x)))
    _, g0 = ops.grad(state.x)
    if rule.tracker_init == "mean":
        h0 = g0.mean(dim=0, keepdim=True).expand_as(g0).clone()
    else:
        h0 = g0.clone()
    state = state._replace(h=cast_aux(h0), g_prev=cast_aux(g0))
    if rule.delay and state.buf is not None:
        # the tracker's stale slots start at h⁰, the natural t < 0 payload
        # (h₋₁ + g₀ − g₋₁ = h⁰), each its own copy
        state = state._replace(buf=(state.buf[0], tuple(
            state.h.clone() for _ in range(rule.delay))))
    return state
